"""3-D UNet backbone (port of brainfm_tpu/models/unet3d.py), on (N, C, D,
H, W) tensors.

Geometric f_maps progression, `layer_order`-driven blocks (default 'gcl' =
GroupNorm -> Conv -> LeakyReLU(0.01), bias-free convs when normalized),
the DoubleConv encoder halving rule, max-pool downsampling, nearest
upsample + concat decoding, `get_feature` returning every decoder level,
the shared-encoder / dual-decoder `UNet3DSep` and the 2-D `UNet2D`
(`is_3d=False` through every block). Module and parameter names are the
reference's, so a state dict loads by name (models/params_io.py).

The JAX package's own forms are ported as it writes them. Every GroupNorm
is `ops/groupnorm.py::fused_group_norm` (`_fused_groupnorm`: sums and a
composite affine, analytic backward, on the kernels K3-K5 of
csrc/groupnorm.cu on the card), with the parameters of the
`nn.GroupNorm` each SingleConv keeps as their holder. A decoder level
whose upsample is an exact 2x on every axis (`Decoder`'s gate, the JAX
`_DecoderStack`'s) takes the pair (enc, z) and never materializes the
upsample or the concat: `pair_group_norm` (`_pair_groupnorm`),
pointwise layers on both parts, then `phase_pair_conv`
(`_phase_pair_conv`: a skip conv on enc plus one phase-folded conv on the
coarse z, then depth-to-space). `phase_upconv: false` in the cfg turns
the pair off, as in the JAX package. `_nearest_upsample_to` repeats by
reshape and expand for the ratios 2s and 2s - 1 (a block-sum backward)
and gathers for any other. `_remat_block` is each DoubleConv's `remat`
mode (`remat_mode`), honoured when gradients are recorded; `save_convs`
keeps one convolution output per SingleConv, the pair's included.

Memory format. The network runs in its input's: NDHWC
(`torch.channels_last_3d`, `channels_last`) where the joiners hand it a
channels-last input (models/build.py: on the card, a space scope's slabs
too), NCDHW otherwise (the CPU, the 2-D UNet). cuDNN's
3-D bf16 convolutions compute in NDHWC, so in NDHWC nothing is converted
around them: each convolution's weight is made NDHWC in the one cast to
autocast's dtype it takes anyway (`conv_weight`; the parameters keep
their layout), GroupNorm's kernels take NDHWC operands, the pair conv's
depth-to-space add and its backward and the nearest upsample (on the
(N, D, H, W, C) view) keep it, and so do max-pool, the concat and every
pointwise layer. The saved convolution outputs of `save_convs` are NDHWC.

Inside `parallel.spatial.space_scope` (the port's counterpart of the JAX
package's GSPMD spatial sharding) the 3-D network runs on D slabs: each
conv takes a halo from its neighbours (`space_conv`), GroupNorm is
`fused_group_norm` with the scope's process group (one all_reduce of K3's
(2, N, C) sums each way, the output in the slab's dtype, as the JAX
SingleConv keeps `_fused_groupnorm` under sharding), max-pool and the
nearest upsample stay local while the slabs are aligned, and the deep
levels that do not split evenly (`level_layout`, the rule of the JAX
package's `_replicate_if_degenerate`) run whole on every rank: their
input is gathered (`gather_space`) and their output sliced back where a
sharded level reads it (`slice_space`). Inside a scope the pair is off at
every level, as the JAX package turns it off under space sharding
(`_space_sharded`). Outside a scope nothing changes.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import Tensor, nn
from torch.utils.flop_counter import conv_flop_count, register_flop_formula

from ..ops.groupnorm import (fused_group_norm, num_groups_of,
                             pair_group_norm)
from ..parallel.spatial import (current_space, gather_space, level_layout,
                                slice_space, space_conv, use_scope, whole)
from ..utils.profiling import count
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)


def feature_maps(f_maps: int, num_levels: int) -> list[int]:
    return [f_maps * 2 ** k for k in range(num_levels)]


def fold_phase_kernel(kb):
    """The coarse tail's 3^3 kernel (co, cz, 3, 3, 3) folded for the 8
    fine output phases into (8 * co, cz, 3, 3, 3), phase-major: output
    channel ((p * 2 + q) * 2 + r) * co + o for the fine phase (p, q, r).
    The JAX package's einsum with `_PHASE_MAP` as sums of taps: on each
    axis a fine tap d lands on coarse tap floor((p + d - 1) / 2) + 1, so
    phase 0 maps taps (0, 1, 2) to (0, 1, 1) and phase 1 to (1, 1, 2)."""
    k = kb
    for d in (-3, -2, -1):
        t0, t1, t2 = k.unbind(d)
        zero = torch.zeros_like(t0)
        k = torch.stack([torch.stack([t0, t1 + t2, zero], d),
                         torch.stack([zero, t0 + t1, t2], d)])
    # (r, q, p, co, cz, 3, 3, 3) -> (p, q, r, co, ...)
    k = k.permute(2, 1, 0, 3, 4, 5, 6, 7)
    return k.reshape(8 * kb.shape[0], *kb.shape[1:])


def _compute_dtype(t):
    """The convolutions' dtype: autocast's where it is on for t's device,
    else t's (the custom operator below is not cast by autocast)."""
    dt = t.device.type
    if torch.amp.is_autocast_available(dt) and torch.is_autocast_enabled(dt):
        return torch.get_autocast_dtype(dt)
    return t.dtype


def channels_last(x) -> bool:
    """Whether the 5-D activation x is NDHWC (`channels_last_3d`): dense
    with channels innermost. One channel or one voxel is both layouts;
    the channel stride decides (1: the joiners' permuted one-channel
    input, a level pooled to one voxel in NDHWC)."""
    return (x.dim() == 5 and x.stride(1) == 1
            and x.is_contiguous(memory_format=torch.channels_last_3d))


def memory_format_of(x):
    return torch.channels_last_3d if channels_last(x) \
        else torch.contiguous_format


def as_format(t, fmt):
    """t dense in `fmt`: itself, or a copy (counted as `layout.copies`)."""
    if t.is_contiguous(memory_format=fmt):
        return t
    count("layout.copies")
    return t.contiguous(memory_format=fmt)


def conv_weight(w, x):
    """A convolution's weight as it meets x: as it is, or where x is NDHWC,
    NDHWC in the one cast to autocast's dtype that autocast would make
    (an fp32 weight under autocast), so that cuDNN converts nothing."""
    if not channels_last(x):
        return w
    dt = _compute_dtype(x) if w.dtype == torch.float32 else w.dtype
    # a copy with NDHWC's own strides, also for a one-channel or 1^3 kernel
    return w.to(dt, memory_format=torch.channels_last_3d, copy=True)


def conv(module, x):
    """module(x) for a convolution module, its weight by `conv_weight`."""
    if not channels_last(x):
        return module(x)
    return module._conv_forward(x, conv_weight(module.weight, x),
                                module.bias)


@torch.library.custom_op("brainfm::phase_pair_conv", mutates_args=())
def _pair_conv(enc: Tensor, z: Tensor, wa: Tensor, kph: Tensor) -> Tensor:
    """conv3x3(enc, wa) + depth_to_space(conv3x3(z, kph)): the two cuDNN
    convolutions of phase_pair_conv as one operator with one output, the
    tensor that `save_convs` keeps (the JAX package's one `conv_out`)."""
    ya = F.conv3d(enc, wa, padding=1)
    yb = F.conv3d(z, kph, padding=1)
    n, co = ya.shape[:2]
    d, h, w = yb.shape[2:]
    # out[n, o, 2i+p, 2j+q, 2k+r] += yb[n, (p, q, r, o), i, j, k], in place
    ya.view(n, co, d, 2, h, 2, w, 2).add_(
        yb.view(n, 2, 2, 2, co, d, h, w).permute(0, 4, 5, 1, 6, 2, 7, 3))
    return ya


@_pair_conv.register_fake
def _(enc, z, wa, kph):
    return torch.empty((enc.shape[0], wa.shape[0]) + tuple(enc.shape[2:]),
                       dtype=enc.dtype, device=enc.device,
                       memory_format=memory_format_of(enc))


def _pair_conv_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


_CONV3 = dict(stride=[1] * 3, padding=[1] * 3, dilation=[1] * 3,
              transposed=False, output_padding=[0] * 3, groups=1)


def _pair_conv_backward(ctx, g):
    enc, z, wa, kph = ctx.saved_tensors
    need = ctx.needs_input_grad
    fmt = memory_format_of(enc)
    g = as_format(g, fmt)
    d_enc, d_wa, _ = torch.ops.aten.convolution_backward(
        g, enc, wa, None, **_CONV3, output_mask=[need[0], need[2], False])
    n, co = g.shape[:2]
    d, h, w = z.shape[2:]
    # gb[n, (p, q, r, o), i, j, k] = g[n, o, 2i+p, 2j+q, 2k+r], in g's layout
    gb = torch.empty((n, 8 * co, d, h, w), dtype=g.dtype, device=g.device,
                     memory_format=fmt)
    gb.view(n, 2, 2, 2, co, d, h, w).copy_(
        g.view(n, co, d, 2, h, 2, w, 2).permute(0, 3, 5, 7, 1, 2, 4, 6))
    d_z, d_kph, _ = torch.ops.aten.convolution_backward(
        gb, z, kph, None, **_CONV3, output_mask=[need[1], need[3], False])
    return d_enc, d_z, d_wa, d_kph


_pair_conv.register_autograd(_pair_conv_backward,
                             setup_context=_pair_conv_setup)


@register_flop_formula(torch.ops.brainfm.phase_pair_conv)
def _pair_conv_flops(enc_shape, z_shape, wa_shape, kph_shape,
                     out_shape=None, **kwargs) -> int:
    coarse = [z_shape[0], kph_shape[0], *z_shape[2:]]
    return (conv_flop_count(list(enc_shape), list(wa_shape), list(out_shape))
            + conv_flop_count(list(z_shape), list(kph_shape), coarse))


def phase_pair_conv(enc, z, weight):
    """`_phase_pair_conv`: the 3^3 'SAME' conv of the virtual
    concat([enc, nearest_up2(z)]) with `weight` (co, ce + cz, 3, 3, 3),
    without materializing the upsample or the concat: a skip conv on enc
    plus one conv of z with the tail folded by the phase map
    (8 * co channels at the coarse grid), then depth-to-space. Both
    convolutions are cuDNN's; the dtype is autocast's where it is on."""
    ce = enc.shape[1]
    dt = _compute_dtype(enc)
    fmt = torch.channels_last_3d if channels_last(enc) \
        else torch.preserve_format
    kph = fold_phase_kernel(weight[:, ce:]).to(dt, memory_format=fmt)
    return _pair_conv(enc.to(dt), z.to(dt),
                      weight[:, :ce].to(dt, memory_format=fmt), kph)


def _pointwise(fn, x):
    return tuple(fn(t) for t in x) if isinstance(x, tuple) else fn(x)


class SingleConv(nn.Module):
    """One `layer_order` unit, e.g. 'gcl': GroupNorm(in) -> Conv -> LeakyReLU.

    The input may be a pair (enc, z) standing for concat([enc,
    nearest_up2(z)]), never materialized (the JAX SingleConv's): GroupNorm
    is `pair_group_norm`, pointwise layers apply to both parts and the conv
    is `phase_pair_conv`, whose output is an ordinary fine-grid tensor.
    `groupnorm` (an nn.GroupNorm) holds the GroupNorm's parameters;
    `fused_group_norm` computes it, over the slabs in a space scope."""

    def __init__(self, in_channels, out_channels, order="gcl", num_groups=8,
                 kernel_size=3, is_3d=True):
        super().__init__()
        if "c" not in order:
            raise ValueError(f"layer order {order!r} has no conv")
        self.order = order
        ch = in_channels
        for c in order:
            if c == "g":
                self.groupnorm = nn.GroupNorm(num_groups_of(ch, num_groups),
                                              ch, eps=1e-5)
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
            pair = isinstance(x, tuple)
            if c == "g":
                gn = self.groupnorm
                if pair:
                    x = pair_group_norm(*x, gn.weight, gn.bias,
                                        gn.num_groups, gn.eps)
                else:
                    x = fused_group_norm(x, gn.weight, gn.bias,
                                         gn.num_groups, gn.eps,
                                         None if sc is None else sc.group)
            elif c == "c":
                if pair:
                    x = phase_pair_conv(*x, self.conv.weight)
                    if self.conv.bias is not None:
                        x = x + self.conv.bias.to(x.dtype).reshape(
                            1, -1, 1, 1, 1)
                elif sc is None:
                    x = conv(self.conv, x)
                else:
                    x = space_conv(self.conv, x, sc)
            elif c == "l":
                x = _pointwise(lambda t: F.leaky_relu(t, 0.01), x)
            elif c == "r":
                x = _pointwise(F.relu, x)
            else:
                x = _pointwise(F.elu, x)
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
    if op in (torch.ops.aten.convolution.default,
              torch.ops.brainfm.phase_pair_conv.default):
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


def _nearest_upsample_to(x, target_spatial, last=None):
    """F.interpolate(mode='nearest') semantics, index floor(i * in / out).
    An axis whose target is 2 * src or 2 * src - 1 repeats each voxel twice
    (then crops), all such axes in one reshape and expand, whose backward
    is a block sum; any other ratio gathers, in exact integer arithmetic.
    With `last` (by default: where x is NDHWC) x is upsampled as its (N,
    D, H, W, C) view and the result is NDHWC."""
    if channels_last(x) if last is None else last:
        return _upsample_axes(x.movedim(1, -1), target_spatial,
                              1).movedim(-1, 1)
    return _upsample_axes(x, target_spatial, 2)


def _upsample_axes(x, target_spatial, first):
    """`_nearest_upsample_to` on the spatial axes first, first + 1, ..."""
    lead, tail = list(x.shape[:first]), list(x.shape[first + len(
        target_spatial):])
    rep = []
    for axis, tgt in enumerate(target_spatial):
        src = x.shape[first + axis]
        if src == tgt:
            rep.append(False)
        elif tgt in (2 * src, 2 * src - 1):
            rep.append(True)
        else:
            rep.append(False)
            idx = torch.arange(tgt, device=x.device) * src // tgt
            x = x.index_select(first + axis, idx)
    if any(rep):
        spatial = x.shape[first:first + len(rep)]
        view, expand = list(lead), list(lead)
        for n, r in zip(spatial, rep):
            view += [n, 1] if r else [n]
            expand += [n, 2] if r else [n]
        # dense, also where the coarse extent is one voxel (no view)
        x = x.reshape(view + tail).expand(expand + tail).contiguous().view(
            *lead, *(2 * n if r else n for n, r in zip(spatial, rep)),
            *tail)
        for axis, tgt in enumerate(target_spatial):
            if x.shape[first + axis] != tgt:
                x = x.narrow(first + axis, 0, tgt)
    return x


class Decoder(nn.Module):
    """Upsample the coarser level to the skip's extent, concatenate,
    DoubleConv. Under the JAX `_DecoderStack`'s gate (`phase_upconv`,
    3-D, out_channels <= 256, every axis exactly 2x, `pair` allowed: no
    space scope) the block takes the pair (enc, x) instead and neither the
    upsample nor the concat is made. (The JAX gate also refuses a 'b' in
    the order; the port has no BatchNorm layer.)"""

    def __init__(self, in_channels, out_channels, order, num_groups,
                 remat=False, is_3d=True, phase_upconv=True):
        super().__init__()
        self.out_channels = out_channels
        self.is_3d = is_3d
        self.phase_upconv = phase_upconv
        self.basic_module = DoubleConv(in_channels, out_channels, False, order,
                                       num_groups, remat, is_3d)

    def forward(self, enc, x, pair=True):
        if (pair and self.phase_upconv and self.is_3d
                and self.out_channels <= 256
                and all(t == 2 * s and s > 0
                        for s, t in zip(x.shape[2:], enc.shape[2:]))):
            return self.basic_module((enc, x))
        # in the skip's layout: a coarse level of one voxel is both
        x = _nearest_upsample_to(x, enc.shape[2:], channels_last(enc))
        return self.basic_module(torch.cat([enc, x], dim=1))


def _decoders(fm, order, num_groups, remat, is_3d, phase_upconv=True):
    rev = fm[::-1]
    return nn.ModuleList(
        Decoder(rev[i + 1] + rev[i], rev[i + 1], order, num_groups, remat,
                is_3d, phase_upconv) for i in range(len(fm) - 1))


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
                x = dec(skip, x, pair=False)
        else:
            if not sc.levels[n - 1 - i]:
                # the level below ran whole: upsample it to this level's
                # whole extent and keep this rank's slab
                x = slice_space(_nearest_upsample_to(
                    x, (skip.shape[2] * sc.n,) + tuple(skip.shape[3:])))
            x = dec(skip, x, pair=False)
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
    """`phase_upconv` (cfg `phase_upconv`, default on): the decoder levels
    with an exact 2x upsample take the pair form (`Decoder`)."""

    def __init__(self, in_channels=1, f_maps=64, num_levels=5,
                 layer_order="gcl", num_groups=8, is_unit_vector=False,
                 remat=False, is_3d=True, phase_upconv=True):
        super().__init__()
        fm = feature_maps(f_maps, num_levels)
        self.is_unit_vector = is_unit_vector
        self.encoders = _encoders(in_channels, fm, layer_order, num_groups,
                                  remat, is_3d)
        self.decoders = _decoders(fm, layer_order, num_groups, remat, is_3d,
                                  phase_upconv)

    def forward(self, x):
        return self.get_feature(x)[-1]

    def get_feature(self, x):
        """[bottleneck, decoder level 1, ..., final], (N, C, D, H, W) in
        x's memory format."""
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
                 remat=False, phase_upconv=True):
        super().__init__()
        fm = feature_maps(f_maps, num_levels)
        self.is_unit_vector = is_unit_vector
        self.encoders = _encoders(in_channels, fm, layer_order, num_groups,
                                  remat, True)
        self.decoders_normal = _decoders(fm, layer_order, num_groups, remat,
                                         True, phase_upconv)
        self.decoders_pathol = _decoders(fm, layer_order, num_groups, remat,
                                         True, phase_upconv)

    def forward(self, x):
        return {k: v[-1] for k, v in self.get_feature(x).items()}

    def get_feature(self, x):
        enc_feats = _encode(self.encoders, x)
        return {"normal": _decode(self.decoders_normal, enc_feats,
                                  self.is_unit_vector),
                "pathology": _decode(self.decoders_pathol, enc_feats,
                                     self.is_unit_vector)}
