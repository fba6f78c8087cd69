"""Task heads (port of brainfm_tpu/models/heads.py), NCDHW (NCHW in 2-D).

`TaskHead` = optional 3x3 ConvBlock stack + one 1x1 conv per named output,
the 1x1 convs computed as ONE conv over their concatenated weights
(`_fused_final_convs`): output channels are independent, so this equals
running each conv on its own. A negative width -n is the pooled scalar
head (age): max-pool 4 -> ConvBlock(16) -> max-pool 4 -> ConvBlock(4) ->
flatten -> Dense 160 -> ReLU -> Dense 10 -> ReLU -> Dense n, squeezed to
(N,) when n = 1. `DepHead` concatenates the input image to the feature.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn


class ConvBlock(nn.Module):
    """3x3 conv + LeakyReLU(0.2)."""

    def __init__(self, in_channels, out_channels, is_3d=True):
        super().__init__()
        conv = nn.Conv3d if is_3d else nn.Conv2d
        self.main = conv(in_channels, out_channels, 3, padding=1)

    def forward(self, x):
        return F.leaky_relu(self.main(x), 0.2)


def _fused_final_convs(x, convs: Dict[str, nn.Module]):
    if not convs:
        return {}
    w = torch.cat([c.weight for c in convs.values()], dim=0)
    b = torch.cat([c.bias for c in convs.values()], dim=0)
    y = (F.conv3d if w.dim() == 5 else F.conv2d)(x, w, b)
    out, off = {}, 0
    for name, c in convs.items():
        out[name] = y[:, off:off + c.out_channels]
        off += c.out_channels
    return out


def scalar_head_width(size, is_3d=True) -> int:
    """Input width of the scalar head's first Dense: the 4 channels of the
    second ConvBlock over the spatial extent after two VALID (flooring)
    4-voxel max-pools of a `size` feature map."""
    n = 4
    for s in tuple(size)[:3 if is_3d else 2]:
        n *= int(s) // 4 // 4
    return n


class TaskHead(nn.Module):
    """in_channels: width of the backbone feature; out_channels: {name: n}
    (n > 0: a 1x1 conv of n channels, n < 0: the pooled scalar head of
    width -n, whose Dense layers are sized for a `size` input; one per
    head). Parameter names are the reference's: `layers.i.main`,
    `final_conv_<name>`, `pool_layers.{1,3}.main` and
    `final_linear{1,2,3}_<name>`."""

    def __init__(self, in_channels, f_maps_list, out_channels: Dict[str, int],
                 size=(160, 160, 160), out_feat_level: int = -1,
                 is_3d: bool = True):
        super().__init__()
        self.out_feat_level = out_feat_level
        chans = [in_channels] + list(f_maps_list)[1:]
        self.layers = nn.ModuleList(ConvBlock(a, b, is_3d)
                                    for a, b in zip(chans[:-1], chans[1:]))
        self.final_names, self.scalar_name = [], None
        conv = nn.Conv3d if is_3d else nn.Conv2d
        pool = nn.MaxPool3d if is_3d else nn.MaxPool2d
        for name, n in out_channels.items():
            if n > 0:
                self.add_module(f"final_conv_{name}", conv(chans[-1], n, 1))
                self.final_names.append(name)
            elif n < 0:
                if self.scalar_name is not None:
                    raise ValueError("one scalar output per head: the "
                                     "reference's pool_layers carry no name")
                self.pool_layers = nn.Sequential(
                    pool(4), ConvBlock(chans[-1], 16, is_3d),
                    pool(4), ConvBlock(16, 4, is_3d))
                for i, (a, b) in enumerate(((scalar_head_width(size, is_3d),
                                             160), (160, 10), (10, -n)), 1):
                    self.add_module(f"final_linear{i}_{name}", nn.Linear(a, b))
                self.scalar_name = name

    def forward(self, feats):
        return self._heads(feats[self.out_feat_level])

    def _heads(self, x):
        for layer in self.layers:
            x = layer(x)
        out = _fused_final_convs(
            x, {n: getattr(self, f"final_conv_{n}") for n in self.final_names})
        name = self.scalar_name
        if name is not None:
            y = self.pool_layers(x)
            # flattened channels-last, as the JAX package flattens (D,H,W,C)
            y = y.movedim(1, -1).reshape(y.shape[0], -1)
            y = F.relu(getattr(self, f"final_linear1_{name}")(y))
            y = F.relu(getattr(self, f"final_linear2_{name}")(y))
            y = getattr(self, f"final_linear3_{name}")(y)
            out[name] = y.squeeze(1) if y.shape[1] == 1 else y
        return out


class DepHead(TaskHead):
    """Contrast-dependent head: the one-channel input image concatenated
    to the feature, then TaskHead's ConvBlock stack and fused 1x1 convs
    (a scalar width is left out, as in the JAX package). Called as
    head(feats, image), both NCDHW."""

    def __init__(self, in_channels, f_maps_list, out_channels: Dict[str, int],
                 out_feat_level: int = -1, is_3d: bool = True):
        super().__init__(in_channels + 1, f_maps_list,
                         {k: n for k, n in out_channels.items() if n > 0},
                         out_feat_level=out_feat_level, is_3d=is_3d)

    def forward(self, feats, image):
        return self._heads(torch.cat([feats[self.out_feat_level], image],
                                     dim=1))
