"""3-D UNet backbone (port of brainfm_tpu/models/unet3d.py), NCDHW.

Geometric f_maps progression, `layer_order`-driven blocks (default 'gcl' =
GroupNorm -> Conv -> LeakyReLU(0.01), bias-free convs when normalized),
the DoubleConv encoder halving rule, max-pool downsampling, nearest
upsample + concat decoding, and `get_feature` returning every decoder
level. Module and parameter names are the reference's, so a state dict
loads by name (models/params_io.py).

The JAX package's TPU workarounds are not ported; their plain forms are,
which tests/test_phase_upconv.py proves equal: `_phase_upconv` /
`_phase_pair_conv` and `_pair_groupnorm` / `_fused_groupnorm` are plain
upsample + concat + Conv3d and nn.GroupNorm; `_remat_block` and
`_replicate_if_degenerate` have no counterpart.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def feature_maps(f_maps: int, num_levels: int) -> list[int]:
    return [f_maps * 2 ** k for k in range(num_levels)]


def _num_groups(channels: int, num_groups: int) -> int:
    if channels < num_groups:
        return 1
    if channels % num_groups:
        raise ValueError(f"{channels} channels in {num_groups} groups")
    return num_groups


class SingleConv(nn.Module):
    """One `layer_order` unit, e.g. 'gcl': GroupNorm(in) -> Conv -> LeakyReLU."""

    def __init__(self, in_channels, out_channels, order="gcl", num_groups=8,
                 kernel_size=3):
        super().__init__()
        if "c" not in order:
            raise ValueError(f"layer order {order!r} has no conv")
        self.order = order
        ch = in_channels
        for c in order:
            if c == "g":
                self.groupnorm = nn.GroupNorm(_num_groups(ch, num_groups), ch,
                                              eps=1e-5)
            elif c == "c":
                self.conv = nn.Conv3d(ch, out_channels, kernel_size,
                                      padding=kernel_size // 2,
                                      bias="g" not in order)
                ch = out_channels
            elif c not in "lre":
                raise ValueError(f"unsupported layer type {c!r}")

    def forward(self, x):
        for c in self.order:
            if c == "g":
                x = self.groupnorm(x)
            elif c == "c":
                x = self.conv(x)
            elif c == "l":
                x = F.leaky_relu(x, 0.01)
            elif c == "r":
                x = F.relu(x)
            else:
                x = F.elu(x)
        return x


class DoubleConv(nn.Module):
    """Two SingleConvs with the encoder halving rule."""

    def __init__(self, in_channels, out_channels, encoder, order="gcl",
                 num_groups=8):
        super().__init__()
        conv1_out = (max(out_channels // 2, in_channels) if encoder
                     else out_channels)
        self.SingleConv1 = SingleConv(in_channels, conv1_out, order,
                                      num_groups)
        self.SingleConv2 = SingleConv(conv1_out, out_channels, order,
                                      num_groups)

    def forward(self, x):
        return self.SingleConv2(self.SingleConv1(x))


class Encoder(nn.Module):
    def __init__(self, in_channels, out_channels, pool, order, num_groups):
        super().__init__()
        self.pool = pool
        self.basic_module = DoubleConv(in_channels, out_channels, True, order,
                                       num_groups)

    def forward(self, x):
        if self.pool:
            x = F.max_pool3d(x, 2)
        return self.basic_module(x)


def _nearest_upsample_to(x, target_spatial):
    """F.interpolate(mode='nearest') semantics, index floor(i * in / out),
    in exact integer arithmetic."""
    for axis, tgt in enumerate(target_spatial):
        src = x.shape[axis + 2]
        if src != tgt:
            idx = torch.arange(tgt, device=x.device) * src // tgt
            x = x.index_select(axis + 2, idx)
    return x


class Decoder(nn.Module):
    def __init__(self, in_channels, out_channels, order, num_groups):
        super().__init__()
        self.basic_module = DoubleConv(in_channels, out_channels, False, order,
                                       num_groups)

    def forward(self, enc, x):
        x = _nearest_upsample_to(x, enc.shape[2:])
        return self.basic_module(torch.cat([enc, x], dim=1))


class UNet3D(nn.Module):
    def __init__(self, in_channels=1, f_maps=64, num_levels=5,
                 layer_order="gcl", num_groups=8, is_unit_vector=False):
        super().__init__()
        fm = feature_maps(f_maps, num_levels)
        self.is_unit_vector = is_unit_vector
        self.encoders = nn.ModuleList(
            Encoder(in_channels if i == 0 else fm[i - 1], fm[i], i > 0,
                    layer_order, num_groups) for i in range(num_levels))
        rev = fm[::-1]
        self.decoders = nn.ModuleList(
            Decoder(rev[i + 1] + rev[i], rev[i + 1], layer_order, num_groups)
            for i in range(num_levels - 1))

    def forward(self, x):
        return self.get_feature(x)[-1]

    def get_feature(self, x):
        """[bottleneck, decoder level 1, ..., final], NCDHW."""
        enc_feats = []
        for enc in self.encoders:
            x = enc(x)
            enc_feats.insert(0, x)
        feats = [enc_feats[0]]
        for dec, skip in zip(self.decoders, enc_feats[1:]):
            x = dec(skip, x)
            feats.append(x)
        if self.is_unit_vector:
            norm = torch.linalg.vector_norm(feats[-1], dim=1, keepdim=True)
            feats[-1] = feats[-1] / norm.clamp(min=1e-12)
        return feats
