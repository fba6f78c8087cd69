"""3-D UNet backbone (port of brainfm_tpu/models/unet3d.py), NCDHW.

Geometric f_maps progression, `layer_order`-driven blocks (default 'gcl' =
GroupNorm -> Conv -> LeakyReLU(0.01), bias-free convs when normalized),
the DoubleConv encoder halving rule, max-pool downsampling, nearest
upsample + concat decoding, `get_feature` returning every decoder level,
the shared-encoder / dual-decoder `UNet3DSep` and the 2-D `UNet2D`
(`is_3d=False` through every block). Module and parameter names are the
reference's, so a state dict loads by name (models/params_io.py).

The JAX package's TPU workarounds are not ported; their plain forms are,
which tests/test_phase_upconv.py proves equal: `_phase_upconv` /
`_phase_pair_conv` and `_pair_groupnorm` / `_fused_groupnorm` are plain
upsample + concat + Conv3d and nn.GroupNorm. `_remat_block` is each
DoubleConv's `remat` mode (`remat_mode`), honoured when gradients are
recorded.

Inside `parallel.spatial.space_scope` (the port's counterpart of the JAX
package's GSPMD spatial sharding) the 3-D network runs on D slabs: each
conv takes a halo from its neighbours (`space_conv`), GroupNorm reduces
its statistics over the slabs (`space_group_norm`), max-pool and the
nearest upsample stay local while the slabs are aligned, and the deep
levels that do not split evenly (`level_layout`, the rule of the JAX
package's `_replicate_if_degenerate`) run whole on every rank: their
input is gathered (`gather_space`) and their output sliced back where a
sharded level reads it (`slice_space`). Outside a scope nothing changes.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.spatial import (current_space, gather_space, level_layout,
                                slice_space, space_conv, space_group_norm,
                                use_scope, whole)
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)


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
                 kernel_size=3, is_3d=True):
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
                conv = nn.Conv3d if is_3d else nn.Conv2d
                self.conv = conv(ch, out_channels, kernel_size,
                                 padding=kernel_size // 2,
                                 bias="g" not in order)
                ch = out_channels
            elif c not in "lre":
                raise ValueError(f"unsupported layer type {c!r}")

    def forward(self, x):
        sc = current_space()
        for c in self.order:
            if c == "g":
                x = (self.groupnorm(x) if sc is None
                     else space_group_norm(x, self.groupnorm, sc))
            elif c == "c":
                x = self.conv(x) if sc is None else space_conv(self.conv, x,
                                                               sc)
            elif c == "l":
                x = F.leaky_relu(x, 0.01)
            elif c == "r":
                x = F.relu(x)
            else:
                x = F.elu(x)
        return x


def remat_mode(remat):
    """The rematerialization mode of cfg.remat: False (save everything),
    'full' (True or 'full': recompute the whole block in the backward) or
    'save_convs' (keep only the convolution outputs, recompute the
    GroupNorm / activation chain). Any other value raises."""
    if not remat:
        return False
    if remat is True or remat == "full":
        return "full"
    if remat == "save_convs":
        return "save_convs"
    raise ValueError(f"unknown remat mode {remat!r}: expected False, "
                     "True/'full', or 'save_convs'")


def _save_convs_policy(ctx, op, *args, **kwargs):
    if op is torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_REMAT_KW = {"full": {},
             "save_convs": {"context_fn": functools.partial(
                 create_selective_checkpoint_contexts, _save_convs_policy)}}


class DoubleConv(nn.Module):
    """Two SingleConvs with the encoder halving rule. With `remat` set and
    gradients recorded, the block runs under activation checkpointing."""

    def __init__(self, in_channels, out_channels, encoder, order="gcl",
                 num_groups=8, remat=False, is_3d=True):
        super().__init__()
        self.remat = remat_mode(remat)
        conv1_out = (max(out_channels // 2, in_channels) if encoder
                     else out_channels)
        self.SingleConv1 = SingleConv(in_channels, conv1_out, order,
                                      num_groups, is_3d=is_3d)
        self.SingleConv2 = SingleConv(conv1_out, out_channels, order,
                                      num_groups, is_3d=is_3d)

    def _block(self, x):
        return self.SingleConv2(self.SingleConv1(x))

    def forward(self, x):
        if self.remat and torch.is_grad_enabled():
            sc = current_space()

            def block(x):   # the recomputation runs in the forward's scope
                with use_scope(sc):
                    return self._block(x)

            return checkpoint(block, x, use_reentrant=False,
                              preserve_rng_state=False,
                              **_REMAT_KW[self.remat])
        return self._block(x)


class Encoder(nn.Module):
    def __init__(self, in_channels, out_channels, pool, order, num_groups,
                 remat=False, is_3d=True):
        super().__init__()
        self.pool = (F.max_pool3d if is_3d else F.max_pool2d) if pool \
            else None
        self.basic_module = DoubleConv(in_channels, out_channels, True, order,
                                       num_groups, remat, is_3d)

    def forward(self, x):
        if self.pool is not None:
            x = self.pool(x, 2)
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
    def __init__(self, in_channels, out_channels, order, num_groups,
                 remat=False, is_3d=True):
        super().__init__()
        self.basic_module = DoubleConv(in_channels, out_channels, False, order,
                                       num_groups, remat, is_3d)

    def forward(self, enc, x):
        x = _nearest_upsample_to(x, enc.shape[2:])
        return self.basic_module(torch.cat([enc, x], dim=1))


def _decoders(fm, order, num_groups, remat, is_3d):
    rev = fm[::-1]
    return nn.ModuleList(
        Decoder(rev[i + 1] + rev[i], rev[i + 1], order, num_groups, remat,
                is_3d) for i in range(len(fm) - 1))


def _decode(decoders, enc_feats, is_unit_vector):
    """[bottleneck, decoder level 1, ..., final] from the encoder features
    (deepest first); the final level unit-normalized over channels when
    `is_unit_vector`. In a space scope a level that runs whole feeds a
    sharded one through its upsample, then `slice_space`."""
    sc = current_space()
    x = enc_feats[0]
    feats = [x]
    n = len(enc_feats)
    for i, (dec, skip) in enumerate(zip(decoders, enc_feats[1:])):
        if sc is None:
            x = dec(skip, x)
        elif not sc.levels[n - 2 - i]:
            with whole():
                x = dec(skip, x)
        else:
            if not sc.levels[n - 1 - i]:
                # the level below ran whole: upsample it to this level's
                # whole extent and keep this rank's slab
                x = slice_space(_nearest_upsample_to(
                    x, (skip.shape[2] * sc.n,) + tuple(skip.shape[3:])))
            x = dec(skip, x)
        feats.append(x)
    if is_unit_vector:
        norm = torch.linalg.vector_norm(feats[-1], dim=1, keepdim=True)
        feats[-1] = feats[-1] / norm.clamp(min=1e-12)
    return feats


def _encoders(in_channels, fm, order, num_groups, remat, is_3d):
    return nn.ModuleList(
        Encoder(in_channels if i == 0 else fm[i - 1], fm[i], i > 0, order,
                num_groups, remat, is_3d) for i in range(len(fm)))


def _encode(encoders, x):
    """Every encoder level's output, deepest first. In a space scope x is
    this rank's D slab; the scope's `levels` is set here."""
    sc = current_space()
    if sc is not None:
        if x.dim() != 5:
            raise ValueError("space sharding splits the D axis of a 3-D "
                             "network's (N, C, D, H, W) input")
        sc.levels = level_layout(x.shape[2] * sc.n, sc.n, len(encoders))
    enc_feats = []
    for k, enc in enumerate(encoders):
        if sc is None or sc.levels[k]:
            x = enc(x)
        else:
            if k == 0 or sc.levels[k - 1]:
                x = gather_space(x, scope=sc)
            with whole():
                x = enc(x)
        enc_feats.insert(0, x)
    return enc_feats


class UNet3D(nn.Module):
    def __init__(self, in_channels=1, f_maps=64, num_levels=5,
                 layer_order="gcl", num_groups=8, is_unit_vector=False,
                 remat=False, is_3d=True):
        super().__init__()
        fm = feature_maps(f_maps, num_levels)
        self.is_unit_vector = is_unit_vector
        self.encoders = _encoders(in_channels, fm, layer_order, num_groups,
                                  remat, is_3d)
        self.decoders = _decoders(fm, layer_order, num_groups, remat, is_3d)

    def forward(self, x):
        return self.get_feature(x)[-1]

    def get_feature(self, x):
        """[bottleneck, decoder level 1, ..., final], NCDHW."""
        return _decode(self.decoders, _encode(self.encoders, x),
                       self.is_unit_vector)


class UNet2D(UNet3D):
    """UNet3D with 2-D convolutions and pooling, on (N, C, H, W)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, is_3d=False)


class UNet3DSep(nn.Module):
    """Shared encoder, normal and pathology decoders. get_feature returns
    {'normal': [...], 'pathology': [...]}, each list as UNet3D's, the two
    sharing the bottleneck."""

    def __init__(self, in_channels=1, f_maps=64, num_levels=5,
                 layer_order="gcl", num_groups=8, is_unit_vector=False,
                 remat=False):
        super().__init__()
        fm = feature_maps(f_maps, num_levels)
        self.is_unit_vector = is_unit_vector
        self.encoders = _encoders(in_channels, fm, layer_order, num_groups,
                                  remat, True)
        self.decoders_normal = _decoders(fm, layer_order, num_groups, remat,
                                         True)
        self.decoders_pathol = _decoders(fm, layer_order, num_groups, remat,
                                         True)

    def forward(self, x):
        return {k: v[-1] for k, v in self.get_feature(x).items()}

    def get_feature(self, x):
        enc_feats = _encode(self.encoders, x)
        return {"normal": _decode(self.decoders_normal, enc_feats,
                                  self.is_unit_vector),
                "pathology": _decode(self.decoders_pathol, enc_feats,
                                     self.is_unit_vector)}
