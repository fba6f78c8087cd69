"""Evaluation metrics and the file-pair protocol (port of
brainfm_tpu/models/evaluator.py): dice, L1, normalized L2, PSNR, SSIM,
MS-SSIM, `Evaluator`.

Tensors stay on their device. SSIM's separable Gaussian filter is a valid
correlation along each axis (one `conv3d` with a 1-D kernel per axis,
TF32 off through `device.exact_fp32`); MS-SSIM's 2x2x2 mean pool is
`avg_pool3d` (floor mode). The label lookups of `label_onehot` and
`hemis_mask_from` are (10000,) int32 tables applied with
ops/lut.py::lut_apply, so on the card they run on K2 (`lut_gather_i32`).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..device import exact_fp32, resolve_device
from ..ops.lut import lut_apply
from ..synth.constants import LABELS_LEFT

# the size of the label lookup tables: FreeSurfer ids lie below it
LUT_SIZE = 10000


def path_stem(p: str) -> str:
    """Path minus its NIfTI extension ('./x.nii.gz' -> './x',
    'out.v2/x.nii' -> 'out.v2/x')."""
    if p.endswith(".nii.gz"):
        return p[: -len(".nii.gz")]
    if p.endswith(".nii"):
        return p[: -len(".nii")]
    return os.path.splitext(p)[0]


def dice(pred_onehot, target_onehot, eps: float = 1e-5):
    """Per-channel dice over the spatial axes of (..., D, H, W, C)."""
    axes = tuple(range(pred_onehot.dim() - 4, pred_onehot.dim() - 1))
    inter = torch.sum(pred_onehot * target_onehot, dim=axes)
    union = torch.sum(pred_onehot + target_onehot, dim=axes)
    return 2.0 * inter / union.clamp(min=eps)


def seg_dice(pred_labels, target_labels, labels):
    """Mean dice over a label list from hard label maps (fp32 counts, as
    the JAX package's; a label absent from both maps scores 1)."""
    scores = []
    for lab in labels:
        p = (pred_labels == lab).float()
        t = (target_labels == lab).float()
        denom = p.sum() + t.sum()
        scores.append(torch.where(denom > 0,
                                  2 * torch.sum(p * t) / denom.clamp(min=1e-5),
                                  1.0))
    return torch.mean(torch.stack(scores))


def l1(pred, target, mask=None):
    d = (pred - target).abs()
    if mask is not None:
        return torch.sum(d * mask) / torch.sum(mask).clamp(min=1.0)
    return torch.mean(d)


def normalized_l2(pred, target, eps: float = 1e-7):
    """The prediction is first scaled onto the target, w = <o,t>/<o,o>, so
    the metric measures the shape error of a bias-field estimate, not its
    gain (parity: evaluator.py:99-102)."""
    w = torch.sum(pred * target) / (torch.sum(pred * pred) + eps)
    return torch.sqrt(torch.sum((w * pred - target) ** 2)
                      / (torch.sum(target * target) + eps))


def psnr(pred, target, data_range=None):
    """Peak = max(target) unless data_range is given."""
    mse = torch.mean((pred - target) ** 2)
    peak = torch.max(target) if data_range is None else data_range
    return 20.0 * torch.log10(peak / torch.sqrt(mse.clamp(min=1e-24)))


def _gaussian_window(size: int, sigma: float, dtype, device):
    x = torch.arange(size, dtype=dtype, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _filter3d(x, win):
    """Separable valid correlation of a (D,H,W, ...) volume with a 1-D
    window along each of its first three axes (trailing axes, such as a
    one-hot's channels, are filtered independently)."""
    n = win.numel()
    rest = x.shape[3:]
    y = x.reshape(*x.shape[:3], -1).permute(3, 0, 1, 2)[:, None]
    with exact_fp32():
        for ax in range(3):
            shape = [1, 1, 1, 1, 1]
            shape[2 + ax] = n
            y = F.conv3d(y, win.reshape(shape))
    return y[:, 0].permute(1, 2, 3, 0).reshape(*y.shape[2:], *rest)


def ssim(pred, target, data_range: float = 1.0, win_size: int = 11,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03,
         return_cs: bool = False):
    """3-D SSIM of (D,H,W) volumes (Wang et al. 2004, the formulation of
    pytorch_msssim), computed in the volumes' dtype."""
    win = _gaussian_window(win_size, sigma, pred.dtype, pred.device)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_p = _filter3d(pred, win)
    mu_t = _filter3d(target, win)
    mu_pp = mu_p * mu_p
    mu_tt = mu_t * mu_t
    mu_pt = mu_p * mu_t
    sig_pp = _filter3d(pred * pred, win) - mu_pp
    sig_tt = _filter3d(target * target, win) - mu_tt
    sig_pt = _filter3d(pred * target, win) - mu_pt
    cs = (2 * sig_pt + c2) / (sig_pp + sig_tt + c2)
    s = ((2 * mu_pt + c1) / (mu_pp + mu_tt + c1)) * cs
    if return_cs:
        return torch.mean(s), torch.mean(cs)
    return torch.mean(s)


def _pool2(x):
    return F.avg_pool3d(x[None, None], 2, 2)[0, 0]


def ms_ssim(pred, target, data_range: float = 1.0, win_size: int = 11,
            weights=(0.0448, 0.2856, 0.3001, 0.2363, 0.1333)):
    """Multi-scale SSIM (Wang et al. 2003); each level halves the volumes
    by a 2x2x2 mean (floor)."""
    weights = torch.as_tensor(weights, dtype=pred.dtype, device=pred.device)
    levels = weights.shape[0]
    mcs = []
    p, t = pred, target
    val = None
    for i in range(levels):
        s, cs = ssim(p, t, data_range, win_size, return_cs=True)
        if i < levels - 1:
            mcs.append(cs.clamp(min=0.0))
            p, t = _pool2(p), _pool2(t)
        else:
            val = s.clamp(min=0.0)
    out = val ** weights[-1]
    for i, cs in enumerate(mcs):
        out = out * cs ** weights[i]
    return out


def _minmax(x):
    lo, hi = torch.min(x), torch.max(x)
    return (x - lo) / (hi - lo).clamp(min=1e-12)


def ssim_normalized(pred, target, **kw):
    """SSIM with data_range 1 after min-max rescaling both volumes to
    [0, 1] (parity: get_ssim, evaluator.py:121-128)."""
    return ssim(_minmax(pred), _minmax(target), 1.0, **kw)


def ms_ssim_normalized(pred, target, **kw):
    """(parity: get_ms_ssim, evaluator.py:130-141)."""
    return ms_ssim(_minmax(pred), _minmax(target), 1.0, **kw)


METRIC_MAP = {
    "l1": l1,
    "psnr": psnr,
    "ssim": ssim_normalized,
    "ms_ssim": ms_ssim_normalized,
    "normalized_l2": normalized_l2,
    # the input is the bias-corrected image; the metric is plain l1
    "corrected_l1": l1,
    "dice": seg_dice,
}

# the 33-label evaluation list (evaluator.py:20-22), distinct from the
# 56-label training list
EVAL_LABELS = [0, 14, 15, 16, 24, 77, 85, 2, 3, 4, 7, 8, 10, 11, 12, 13,
               17, 18, 26, 28, 41, 42, 43, 46, 47, 49, 50, 51, 52, 53, 54,
               58, 60]
N_NEUTRAL_EVAL = 7
# left-hemisphere labels for hemisphere masking (scripts/test.py:23-35):
# the training list of the left-hemisphere models
LEFT_HEMIS_LABELS = LABELS_LEFT

_LONG_METRICS = ("ms_ssim", "normalized_l2", "corrected_l1")


def align_shape(a, b):
    """Crop both volumes to their common leading (D, H, W)."""
    if a.shape != b.shape:
        s = min(a.shape[0], b.shape[0])
        r = min(a.shape[1], b.shape[1])
        c = min(a.shape[2], b.shape[2])
        a = a[:s, :r, :c]
        b = b[:s, :r, :c]
    return a, b


def index_lut(labels, device):
    """The (LUT_SIZE,) int32 table label id -> its index in `labels`."""
    lut = np.zeros(LUT_SIZE, np.int32)
    for i, lab in enumerate(labels):
        lut[lab] = i
    return torch.from_numpy(lut).to(device)


def _lookup(labels, label_map):
    """Indices of a label map's ids in `labels`, through K2 on CUDA."""
    label_map = torch.as_tensor(label_map).squeeze()
    lut = index_lut(labels, label_map.device)
    return lut_apply(lut, label_map.to(torch.int32).contiguous())


def label_onehot(label, labels=None):
    """One-hot (D,H,W,C) fp32 of a label map over the evaluation list
    (parity: get_onehot, evaluator.py:30-39; channels last). Ids in
    [0, 9999] outside the list count as its first entry, as in the JAX
    package; ids outside [0, 9999] do too (K2 gives 0 there), where the
    JAX package's numpy lookup would wrap a negative id and raise on one
    of 10000 or more."""
    labels = list(labels) if labels is not None else EVAL_LABELS
    return F.one_hot(_lookup(labels, label).long(), len(labels)).float()


def hemis_mask_from(seg, regx):
    """Left-hemisphere mask (fp32): voxels whose label is a left-hemisphere
    label other than background and whose predicted MNI x is negative
    (parity: scripts/test.py:29-35, `M = (S > 0) & (X < 0)`). Ids outside
    [0, 9999] count as background (K2 gives 0), where the JAX package's
    numpy lookup would wrap or raise."""
    s = _lookup(LEFT_HEMIS_LABELS, seg)
    x = torch.as_tensor(regx).squeeze().to(s.device)
    return ((s > 0) & (x < 0)).float()


def _metric_of(name: str):
    """(prefix, metric) of a metric name such as 'recon_ms_ssim'."""
    prefix, metric = name.rsplit("_", 1) if "_" in name else (name, name)
    for long in _LONG_METRICS:
        if name.endswith(long):
            prefix, metric = name[: -(len(long) + 1)], long
    return prefix, metric


class Evaluator:
    """Metric-name driven evaluation (parity: Evaluator,
    evaluator.py:55-195), names like 'recon_psnr' or 'seg_dice'. `device`:
    where eval_files scores (CUDA unless the caller asks for another)."""

    def __init__(self, metric_names, labels=None, device=None):
        self.metric_names = list(metric_names)
        self.labels = labels
        self.device = resolve_device(device)

    def eval_files(self, pred_path: str, target_path: str,
                   clamp: bool = False, is_seg: bool = None,
                   normalize: bool = False, add_mask: bool = False,
                   flip: bool = False, kill_target_labels=(),
                   hemis_mask=None):
        """The file-pair protocol (parity: Evaluator.eval,
        evaluator.py:147-195): load both volumes, crop to the common shape,
        optionally flip the prediction sagittally, zero killed labels,
        apply `hemis_mask`, mask the prediction by the target (writing a
        `<pred>_masked.nii.gz` companion), min-max normalize, one-hot
        segmentations over the evaluation list (K2), clamp to [0, 1], then
        score every metric. Segmentations round half to even, as
        `np.rint`."""
        from ..utils.nifti import load_nifti, save_nifti

        if is_seg is None:
            is_seg = "label" in os.path.basename(pred_path)
        pred, aff = load_nifti(pred_path)
        target, _ = load_nifti(target_path)
        dev = self.device
        pred = torch.from_numpy(np.ascontiguousarray(np.squeeze(pred))).to(dev)
        target = torch.from_numpy(
            np.ascontiguousarray(np.squeeze(target))).to(dev)
        if is_seg:
            pred = torch.round(pred.double()).to(torch.int32)
            target = torch.round(target.double()).to(torch.int32)
        pred, target = align_shape(pred, target)
        if flip:
            pred = torch.flip(pred, (0,))
        for lab in kill_target_labels:
            target = torch.where(target == lab, 0, target)
            pred = torch.where(pred == lab, 0, pred)
        if hemis_mask is not None:
            m = torch.as_tensor(hemis_mask).to(dev)
            m = m[: pred.shape[0], : pred.shape[1], : pred.shape[2]]
            pred = pred * m
            target = target * m
        if add_mask and "_masked" not in pred_path:
            pred = torch.where(target == 0, 0, pred)
            pred = torch.where(pred < 0, 0, pred)
            save_nifti(path_stem(pred_path) + "_masked.nii.gz",
                       pred.cpu().numpy().astype(np.float32), aff)
        if normalize:
            lo = torch.min(pred)
            pred = (pred - lo) / max(float(torch.max(pred) - lo), 1e-12)
        if is_seg:
            pred_t = label_onehot(pred, self.labels)
            target_t = label_onehot(target, self.labels)
        else:
            pred_t = pred.float()
            target_t = target.float()
        if clamp:
            pred_t = pred_t.clamp(0.0, 1.0)
            target_t = target_t.clamp(0.0, 1.0)

        score = {}
        for name in self.metric_names:
            metric = _metric_of(name)[1]
            if metric == "dice":
                score[name] = float(torch.mean(dice(pred_t, target_t)))
            else:
                score[name] = float(METRIC_MAP[metric](pred_t, target_t))
        return score

    def eval(self, outputs: dict, targets: dict):
        """Scores of output and target tensors by key ('label' or
        'pathology' for dice; 'T1', 'high_res', 'bias_field' for the recon,
        sr and bf prefixes). A 4-D (S, D, H, W) output is scored per sample
        against a 3-D target (or its own sample of a 4-D one) and
        averaged."""
        res = {}
        for name in self.metric_names:
            prefix, metric = _metric_of(name)
            if metric == "dice":
                key = "label" if "seg" in prefix else "pathology"
                if key in outputs and key in targets:
                    # the 33-label list by default: [1] is not a produced
                    # FreeSurfer id, so dice on it would score two empty
                    # masks as a constant 1
                    res[name] = float(seg_dice(
                        torch.as_tensor(outputs[key]).squeeze(),
                        torch.as_tensor(targets[key]).squeeze(),
                        self.labels or EVAL_LABELS))
                continue
            src = {"recon": "T1", "sr": "high_res", "bf": "bias_field",
                   "feat": "T1"}.get(prefix, prefix)
            if src in outputs and src in targets:
                fn = METRIC_MAP[metric]
                a = torch.as_tensor(outputs[src]).squeeze()
                b = torch.as_tensor(targets[src]).squeeze()
                # score each sample: ssim's 3-D filter would otherwise blur
                # across the sample axis and never along W
                if a.dim() == 4 and b.dim() == 3:
                    res[name] = float(np.mean([float(fn(ai, b)) for ai in a]))
                elif a.dim() == 4 and b.dim() == 4:
                    res[name] = float(np.mean(
                        [float(fn(ai, bi)) for ai, bi in zip(a, b)]))
                else:
                    res[name] = float(fn(a, b))
        return res
