"""Task heads (port of brainfm_tpu/models/heads.py), NCDHW.

`TaskHead` = optional 3x3 ConvBlock stack + one 1x1 conv per named output,
the 1x1 convs computed as ONE conv over their concatenated weights
(`_fused_final_convs`): output channels are independent, so this equals
running each conv on its own. The pooled scalar head (age, negative
widths) is not ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn


class ConvBlock(nn.Module):
    """3x3 conv + LeakyReLU(0.2)."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.main = nn.Conv3d(in_channels, out_channels, 3, padding=1)

    def forward(self, x):
        return F.leaky_relu(self.main(x), 0.2)


def _fused_final_convs(x, convs: Dict[str, nn.Conv3d]):
    if not convs:
        return {}
    w = torch.cat([c.weight for c in convs.values()], dim=0)
    b = torch.cat([c.bias for c in convs.values()], dim=0)
    y = F.conv3d(x, w, b)
    out, off = {}, 0
    for name, c in convs.items():
        out[name] = y[:, off:off + c.out_channels]
        off += c.out_channels
    return out


class TaskHead(nn.Module):
    """in_channels: width of the backbone feature; out_channels: {name: n}."""

    def __init__(self, in_channels, f_maps_list, out_channels: Dict[str, int],
                 out_feat_level: int = -1):
        super().__init__()
        self.out_feat_level = out_feat_level
        chans = [in_channels] + list(f_maps_list)[1:]
        self.layers = nn.ModuleList(ConvBlock(a, b)
                                    for a, b in zip(chans[:-1], chans[1:]))
        self.final_names = []
        for name, n in out_channels.items():
            if n < 0:
                raise NotImplementedError(
                    f"scalar head {name!r} (pooled FC) is not ported yet")
            if n > 0:
                self.add_module(f"final_conv_{name}",
                                nn.Conv3d(chans[-1], n, 1))
                self.final_names.append(name)

    def forward(self, feats):
        x = feats[self.out_feat_level]
        for layer in self.layers:
            x = layer(x)
        return _fused_final_convs(
            x, {n: getattr(self, f"final_conv_{n}") for n in self.final_names})
