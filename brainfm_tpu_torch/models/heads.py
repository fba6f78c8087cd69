"""Task heads (port of brainfm_tpu/models/heads.py), on (N, C, D, H, W)
tensors ((N, C, H, W) in 2-D) in the backbone's memory format (NDHWC on
the card, models/unet3d.py): the convolutions take their weights by
`unet3d.conv_weight`, and the fused 1x1 conv's outputs are split along
channels, so each head's output keeps the layout.

`TaskHead` = optional 3x3 ConvBlock stack + one 1x1 conv per named output,
the 1x1 convs computed as ONE conv over their concatenated weights
(`_fused_final_convs`): output channels are independent, so this equals
running each conv on its own. A negative width -n is the pooled scalar
head (age): max-pool 4 -> ConvBlock(16) -> max-pool 4 -> ConvBlock(4) ->
flatten -> Dense 160 -> ReLU -> Dense 10 -> ReLU -> Dense n, squeezed to
(N,) when n = 1. `DepHead` concatenates the input image to the feature.

In a space scope (parallel/spatial.py) the 3x3 convs take a halo from
the neighbouring slabs, the 1x1 convs stay local, a head on a level that
runs whole runs whole, and the pooled scalar head gathers its feature
whole (`gather_space`) and runs whole on every rank.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.spatial import (current_space, gather_space, space_conv,
                                whole)
from .unet3d import channels_last, conv, conv_weight, memory_format_of


class ConvBlock(nn.Module):
    """3x3 conv + LeakyReLU(0.2)."""

    def __init__(self, in_channels, out_channels, is_3d=True):
        super().__init__()
        conv = nn.Conv3d if is_3d else nn.Conv2d
        self.main = conv(in_channels, out_channels, 3, padding=1)

    def forward(self, x):
        sc = current_space()
        y = conv(self.main, x) if sc is None else space_conv(self.main, x,
                                                              sc)
        return F.leaky_relu(y, 0.2)


class _SplitChannels(torch.autograd.Function):
    """y.split(sizes, dim=1), whose backward writes the parts' gradients
    into one tensor in y's memory format, zeros where a part has none
    (torch's split concatenates them, and a part without a gradient joins
    as NCDHW zeros, which turns the whole gradient NCDHW)."""

    @staticmethod
    def forward(ctx, y, sizes):
        ctx.sizes, ctx.shape = sizes, y.shape
        ctx.dtype, ctx.fmt = y.dtype, memory_format_of(y)
        ctx.set_materialize_grads(False)
        return y.split(sizes, dim=1)

    @staticmethod
    def backward(ctx, *grads):
        g = torch.empty(ctx.shape, dtype=ctx.dtype, device=next(
            t for t in grads if t is not None).device,
            memory_format=ctx.fmt)
        off = 0
        for gi, n in zip(grads, ctx.sizes):
            part = g.narrow(1, off, n)
            if gi is None:
                part.zero_()
            else:
                part.copy_(gi)
            off += n
        return g, None


def _fused_final_convs(x, convs: Dict[str, nn.Module]):
    if not convs:
        return {}
    ws = [c.weight for c in convs.values()]
    bs = [c.bias for c in convs.values()]
    sizes = [c.out_channels for c in convs.values()]
    # NDHWC: zero outputs up to a multiple of 8 (cuDNN's NDHWC backward
    # converts the layout of any other width, the flagship's 68 included)
    pad = -sum(sizes) % 8 if channels_last(x) else 0
    if pad:
        ws.append(ws[0].new_zeros((pad,) + tuple(ws[0].shape[1:])))
        bs.append(bs[0].new_zeros(pad))
    w = conv_weight(torch.cat(ws, dim=0), x)
    y = (F.conv3d if w.dim() == 5 else F.conv2d)(x, w, torch.cat(bs))
    return dict(zip(convs, _SplitChannels.apply(y, sizes + [pad])))


def scalar_head_width(size, is_3d=True) -> int:
    """Input width of the scalar head's first Dense: the 4 channels of the
    second ConvBlock over the spatial extent after two VALID (flooring)
    4-voxel max-pools of a `size` feature map."""
    n = 4
    for s in tuple(size)[:3 if is_3d else 2]:
        n *= int(s) // 4 // 4
    return n


def _level_whole(feats, idx) -> bool:
    """In a space scope: whether feature level `feats[idx]` ran whole on
    every rank (feats is [bottleneck, ..., final])."""
    sc = current_space()
    if sc is None:
        return False
    L = len(feats)
    return not sc.levels[L - 1 - (idx % L)]


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
        if _level_whole(feats, self.out_feat_level):
            with whole():
                return self._heads(feats[self.out_feat_level])
        return self._heads(feats[self.out_feat_level])

    def _heads(self, x):
        for layer in self.layers:
            x = layer(x)
        out = _fused_final_convs(
            x, {n: getattr(self, f"final_conv_{n}") for n in self.final_names})
        name = self.scalar_name
        if name is not None:
            if current_space() is not None:
                xw = gather_space(x)
                with whole():
                    y = self.pool_layers(xw)
            else:
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
        if _level_whole(feats, self.out_feat_level):
            image = gather_space(image)
            with whole():
                return self._heads(torch.cat(
                    [feats[self.out_feat_level], image], dim=1))
        return self._heads(torch.cat([feats[self.out_feat_level], image],
                                     dim=1))
