"""The plain reference of the BrainFM models the benchmark measures.

UNet3D and UNet3D-Sep with their task heads, written from the layer
equations in plain PyTorch: every GroupNorm is `F.group_norm`, every
convolution `F.conv3d`, every decoder level a nearest 2x upsample and a
concat, with none of the port's fused forms, kernels or rematerialisation.
Module and parameter names are the port's (and the reference BrainFM
repo's), so one state dict loads into both. Inputs and outputs are
channels last, (N, D, H, W, C), as the port's joiners take and give them.

`quant` selects the arithmetic of every convolution:
None computes in the inputs' dtype (float32 for the reference); "fp8"
rounds each convolution's input and weight to float8 e4m3 with one scale
per tensor (its absolute maximum onto 448) and computes in float32: the
benchmark's lower-precision control. `checkpointed` recomputes each
DoubleConv in the backward (torch.utils.checkpoint), which changes no
value and lets a 160^3 float32 step fit on one card.

Also here, as frozen copies of the port's plain code (models/build.py):
`process_args`, the output processors and `postprocess` with the label
table lookup in plain indexing.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .synth.constants import LABELS_EXTRACEREBRAL, LABELS_LEFT

FP8_MAX = 448.0


class Cfg(dict):
    """dict with attribute access; missing keys read as None (the port's
    config object behaves the same)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            return None

    def __setattr__(self, name, value):
        self[name] = value

    @staticmethod
    def from_nested(d):
        if isinstance(d, dict):
            return Cfg({k: Cfg.from_nested(v) for k, v in d.items()})
        if isinstance(d, list):
            return [Cfg.from_nested(v) for v in d]
        return d


def fp8_round(t):
    """t rounded to float8 e4m3 under one per-tensor scale (amax -> 448),
    returned in float32. The rounding is on the values only: the gradient
    passes through it unchanged, in float32 (a float8 copy of the gradient
    itself would underflow)."""
    t = t.float()
    with torch.no_grad():
        scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
        q = (t / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach()


def conv(x, w, b=None, quant=None, padding=0):
    if quant == "fp8":
        x, w = fp8_round(x), fp8_round(w)
        b = None if b is None else b.float()
    return F.conv3d(x, w, b, padding=padding)


def num_groups_of(channels: int, num_groups: int) -> int:
    """GroupNorm groups for `channels`: one group when there are fewer
    channels than groups, as the JAX package and the port choose them."""
    if channels < num_groups:
        return 1
    if channels % num_groups:
        raise ValueError(f"{channels} channels in {num_groups} groups")
    return num_groups


class SingleConv(nn.Module):
    """'gcl': GroupNorm -> Conv 3^3 (no bias) -> LeakyReLU(0.01)."""

    def __init__(self, cin, cout, num_groups):
        super().__init__()
        self.groupnorm = nn.GroupNorm(num_groups_of(cin, num_groups), cin,
                                      eps=1e-5)
        self.conv = nn.Conv3d(cin, cout, 3, padding=1, bias=False)
        self.quant = None

    def forward(self, x):
        gn = self.groupnorm
        x = F.group_norm(x, gn.num_groups, gn.weight, gn.bias, gn.eps)
        x = conv(x, self.conv.weight, None, self.quant, padding=1)
        return F.leaky_relu(x, 0.01)


class DoubleConv(nn.Module):
    def __init__(self, cin, cout, encoder, num_groups):
        super().__init__()
        mid = max(cout // 2, cin) if encoder else cout
        self.SingleConv1 = SingleConv(cin, mid, num_groups)
        self.SingleConv2 = SingleConv(mid, cout, num_groups)
        self.checkpointed = False

    def _block(self, x):
        return self.SingleConv2(self.SingleConv1(x))

    def forward(self, x):
        if self.checkpointed and torch.is_grad_enabled():
            return checkpoint(self._block, x, use_reentrant=False)
        return self._block(x)


class Encoder(nn.Module):
    def __init__(self, cin, cout, pool, num_groups):
        super().__init__()
        self.pool = pool
        self.basic_module = DoubleConv(cin, cout, True, num_groups)

    def forward(self, x):
        if self.pool:
            x = F.max_pool3d(x, 2)
        return self.basic_module(x)


class Decoder(nn.Module):
    def __init__(self, cin, cout, num_groups):
        super().__init__()
        self.basic_module = DoubleConv(cin, cout, False, num_groups)

    def forward(self, enc, x):
        x = F.interpolate(x, size=tuple(enc.shape[2:]), mode="nearest")
        return self.basic_module(torch.cat([enc, x], dim=1))


def _fm(f_maps, num_levels):
    return [f_maps * 2 ** k for k in range(num_levels)]


def _encoders(cin, fm, num_groups):
    return nn.ModuleList(Encoder(cin if i == 0 else fm[i - 1], fm[i], i > 0,
                                 num_groups) for i in range(len(fm)))


def _decoders(fm, num_groups):
    rev = fm[::-1]
    return nn.ModuleList(Decoder(rev[i + 1] + rev[i], rev[i + 1], num_groups)
                         for i in range(len(fm) - 1))


def _encode(encoders, x):
    feats = []
    for enc in encoders:
        x = enc(x)
        feats.insert(0, x)
    return feats


def _decode(decoders, enc_feats, unit):
    x = enc_feats[0]
    feats = [x]
    for dec, skip in zip(decoders, enc_feats[1:]):
        x = dec(skip, x)
        feats.append(x)
    if unit:
        n = torch.linalg.vector_norm(feats[-1], dim=1, keepdim=True)
        feats[-1] = feats[-1] / n.clamp(min=1e-12)
    return feats


class UNet3D(nn.Module):
    def __init__(self, in_channels, f_maps, num_levels, num_groups, unit):
        super().__init__()
        fm = _fm(f_maps, num_levels)
        self.unit = unit
        self.encoders = _encoders(in_channels, fm, num_groups)
        self.decoders = _decoders(fm, num_groups)

    def get_feature(self, x):
        return _decode(self.decoders, _encode(self.encoders, x), self.unit)


class UNet3DSep(nn.Module):
    def __init__(self, in_channels, f_maps, num_levels, num_groups, unit):
        super().__init__()
        fm = _fm(f_maps, num_levels)
        self.unit = unit
        self.encoders = _encoders(in_channels, fm, num_groups)
        self.decoders_normal = _decoders(fm, num_groups)
        self.decoders_pathol = _decoders(fm, num_groups)

    def get_feature(self, x):
        enc = _encode(self.encoders, x)
        return {"normal": _decode(self.decoders_normal, enc, self.unit),
                "pathology": _decode(self.decoders_pathol, enc, self.unit)}


class ConvBlock(nn.Module):
    """3^3 conv with bias + LeakyReLU(0.2)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.main = nn.Conv3d(cin, cout, 3, padding=1)
        self.quant = None

    def forward(self, x):
        return F.leaky_relu(conv(x, self.main.weight, self.main.bias,
                                 self.quant, padding=1), 0.2)


class TaskHead(nn.Module):
    """ConvBlocks over task_f_maps, then one 1x1 conv per output."""

    def __init__(self, cin, f_maps_list, out_channels: Dict[str, int]):
        super().__init__()
        chans = [cin] + list(f_maps_list)[1:]
        self.layers = nn.ModuleList(ConvBlock(a, b)
                                    for a, b in zip(chans[:-1], chans[1:]))
        self.names = []
        for name, n in out_channels.items():
            if n <= 0:
                raise ValueError(f"head {name}: the reference has no "
                                 "pooled scalar head")
            self.add_module(f"final_conv_{name}", nn.Conv3d(chans[-1], n, 1))
            self.names.append(name)
        self.quant = None

    def forward(self, feats):
        x = feats[-1]
        for layer in self.layers:
            x = layer(x)
        out = {}
        for name in self.names:
            c = getattr(self, f"final_conv_{name}")
            out[name] = conv(x, c.weight, c.bias, self.quant)
        return out


def _ndhwc(x):
    return x.movedim(1, -1)


class Joiner(nn.Module):
    def __init__(self, backbone, head):
        super().__init__()
        self.backbone = backbone
        self.head = head

    def forward(self, x):
        feats = self.backbone.get_feature(x.movedim(-1, 1))
        return {k: _ndhwc(v) for k, v in self.head(feats).items()}


class SepJoiner(nn.Module):
    def __init__(self, backbone, head_normal, head_pathol):
        super().__init__()
        self.backbone = backbone
        self.head_normal = head_normal
        self.head_pathol = head_pathol

    def forward(self, x):
        feats = self.backbone.get_feature(x.movedim(-1, 1))
        out = {k: _ndhwc(v) for k, v in self.head_normal(
            feats["normal"]).items()}
        out.update({k: _ndhwc(v) for k, v in self.head_pathol(
            feats["pathology"]).items()})
        return out


def process_args(cfg):
    """Output channels and names from the task toggles (a frozen copy of
    the port's models/build.py::process_args, without the tasks the
    benchmark's configurations do not use)."""
    cfg.tasks = [k for k, v in dict(cfg.task).items() if v]
    left = bool(cfg.generator.left_hemis_only)
    cfg.label_list_segmentation = LABELS_LEFT if left else LABELS_EXTRACEREBRAL
    cfg.n_labels = len(cfg.label_list_segmentation)
    if cfg.losses and cfg.losses.uncertainty is not None:
        raise ValueError("the reference has no uncertainty heads")
    out = {}
    for t in ("T1", "T2", "FLAIR", "CT"):
        if t in cfg.tasks:
            out[t] = 1
    if "bias_field" in cfg.tasks:
        out["bias_field_log"] = 1
    if "segmentation" in cfg.tasks:
        out["segmentation"] = cfg.n_labels
    if "distance" in cfg.tasks:
        out["distance"] = 2 if left else 4
    if "registration" in cfg.tasks:
        out["registration"] = 3
    if "pathology" in cfg.tasks:
        out["pathology"] = 1
    unknown = set(cfg.tasks) - {"T1", "T2", "FLAIR", "CT", "bias_field",
                                "segmentation", "distance", "registration",
                                "pathology"}
    if unknown:
        raise ValueError(f"tasks the reference lacks: {sorted(unknown)}")
    cfg.out_channels = out
    return cfg


def build_model(cfg, device):
    """The reference model of a processed config, float32 on `device`."""
    cfg = process_args(cfg)
    args = (int(cfg.in_channels or 1), int(cfg.f_maps or 64),
            int(cfg.num_levels or 5), int(cfg.num_groups or 8),
            bool(cfg.unit_feat))
    if (cfg.layer_order or "gcl") != "gcl":
        raise ValueError("the reference builds 'gcl' blocks only")
    fm, tfm = int(cfg.f_maps or 64), tuple(cfg.task_f_maps or [64])
    if "sep" in (cfg.backbone or "unet3d"):
        rest = {k: v for k, v in cfg.out_channels.items() if k != "pathology"}
        model = SepJoiner(UNet3DSep(*args), TaskHead(fm, tfm, rest),
                          TaskHead(fm, tfm, {"pathology": 1}))
    else:
        model = Joiner(UNet3D(*args), TaskHead(fm, tfm, cfg.out_channels))
    return cfg, model.to(device)


def set_arithmetic(model, quant=None, checkpointed=False):
    """Every layer's `quant` (None or 'fp8') and every DoubleConv's
    recomputation in the backward."""
    for m in model.modules():
        if hasattr(m, "quant"):
            m.quant = quant
        if isinstance(m, DoubleConv):
            m.checkpointed = checkpointed
    return model


def apply_processors(out: dict, cfg) -> dict:
    out = dict(out)
    if "segmentation" in out:
        out["segmentation"] = torch.softmax(out["segmentation"], dim=-1)
    if "distance" in out:
        m = float(cfg.max_surf_distance or 3.0)
        out["distance"] = out["distance"].clamp(-m, m)
    if "pathology" in out:
        out["pathology"] = torch.sigmoid(out["pathology"])
    return out


def _fake_cortical(p, w, a=2.0):
    return (70 * (1 - (torch.tanh(a * (w + 0.3)) + 1) / 2)
            + 40 * (1 - (torch.tanh(a * p) + 1) / 2))


def postprocess(out: dict, cfg) -> dict:
    """The served outputs of processed outputs: the distance split and the
    fake-cortical render, the registration split, the bias field's exp,
    the label map (the label table at the argmax) and the CT rescale."""
    out = dict(out)
    tasks = cfg.tasks
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
        lab = torch.tensor(list(cfg.label_list_segmentation),
                           dtype=torch.int32, device=out["segmentation"].device)
        out["label"] = lab[torch.argmax(out["segmentation"], dim=-1)][..., None]
    if "CT" in tasks and "CT" in out:
        out["CT"] = out["CT"] * 1000.0
    return out
