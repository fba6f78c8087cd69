"""Spatial (volume) sharding: the conv halo exchange, the stencil
network wrapper and the space scope (port of
brainfm_tpu/parallel/spatial.py and of what GSPMD does for the JAX UNet).

The volume's D axis is split into equal slabs over the mesh 'space' axis.
Every exchange is an `all_gather` or an `all_reduce`, never send/recv, so
the same code runs under NCCL and under gloo (which stages CUDA tensors
through the host and takes all_gather and all_reduce on them).

`space_scope(mesh)` is the port's counterpart of JAX's ambient
`jax.sharding.set_mesh`: inside it the UNet (models/unet3d.py) and its
heads (models/heads.py) run on the local slab, with halo exchanges before
their convs, GroupNorm statistics summed over the slabs (the scope's
group handed to ops/groupnorm.py::fused_group_norm), and the deep levels
that do not split evenly run whole on every rank. `whole()` leaves
the scope for a block that runs whole.

Gradients: a loss computed whole on every rank (after `gather_space`) is
scaled by 1/n_space by the caller; then the backward of every exchange
here hands each rank its share, and one SUM over the ranks gives the
gradient of the unsharded computation.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from .mesh import axis_index, axis_size, local_slice


def _all_gather(x, group):
    """Every rank's x, in x's layout: a channels-last (NDHWC) x is sent as
    its contiguous (N, D, H, W, C) view, so that no layout is converted."""
    last = not x.is_contiguous() and x.movedim(1, -1).is_contiguous()
    x = x.movedim(1, -1) if last else x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return [p.movedim(-1, 1) for p in parts] if last else parts


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, halo, group, dim):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        D = local.shape[dim]
        if D < halo:
            raise ValueError(f"slab extent {D} below the halo {halo}")
        ctx.halo, ctx.group, ctx.dim, ctx.D = halo, group, dim, D
        edges = torch.cat([local.narrow(dim, 0, halo),
                           local.narrow(dim, D - halo, halo)], dim)
        parts = _all_gather(edges, group)
        zeros = torch.zeros_like(local.narrow(dim, 0, halo))
        from_left = parts[r - 1].narrow(dim, halo, halo) if r > 0 else zeros
        from_right = (parts[r + 1].narrow(dim, 0, halo) if r < n - 1
                      else zeros)
        return torch.cat([from_left, local, from_right], dim)

    @staticmethod
    def backward(ctx, g):
        halo, group, dim, D = ctx.halo, ctx.group, ctx.dim, ctx.D
        n, r = dist.get_world_size(group), dist.get_rank(group)
        # this rank's halos belong to its neighbours' edges
        sent = torch.cat([g.narrow(dim, 0, halo),
                          g.narrow(dim, D + halo, halo)], dim)
        parts = _all_gather(sent, group)
        out = g.narrow(dim, halo, D).clone()
        if r > 0:   # the left neighbour's right halo is my left edge
            out.narrow(dim, 0, halo).add_(parts[r - 1].narrow(dim, halo,
                                                              halo))
        if r < n - 1:
            out.narrow(dim, D - halo, halo).add_(parts[r + 1].narrow(dim, 0,
                                                                     halo))
        return out, None, None, None


def halo_exchange(local, halo: int, group, dim: int = 2):
    """Append `halo` voxels from each neighbouring slab along `dim` (D of
    a (B, C, D, H, W) slab), zeros at the two ends of the space axis (the
    'SAME' zero padding at the volume's ends). Differentiable: each halo's
    gradient goes back to the rank that owns it."""
    return _HaloExchange.apply(local, int(halo), group, dim)


class _GatherSpace(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.m = group, dim, x.shape[dim]
        return torch.cat(_all_gather(x, group), dim)

    @staticmethod
    def backward(ctx, g):
        # a fresh contiguous tensor, an NDHWC g's (N, D, H, W, C) view
        last = not g.is_contiguous() and g.movedim(1, -1).is_contiguous()
        v = (g.movedim(1, -1) if last else g.contiguous()).clone()
        dist.all_reduce(v, group=ctx.group)
        g = v.movedim(-1, 1) if last else v
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.m, ctx.m).clone(), None, None


class _SliceSpace(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n, r, dim):
        ctx.n, ctx.r, ctx.dim = n, r, dim
        return local_slice(x, n, r, dim).clone()

    @staticmethod
    def backward(ctx, g):
        zero = torch.zeros_like(g)   # in g's layout, as the concat is
        return torch.cat([g if q == ctx.r else zero for q in range(ctx.n)],
                         ctx.dim), None, None, None


@dataclass
class SpaceScope:
    """The active space sharding: the 'space' process group, its size and
    this rank's slab index. `levels` (one flag per UNet level, full
    resolution first) is set by the UNet's encoder: which levels run on
    slabs (True) and which run whole on every rank."""

    group: object
    n: int
    rank: int
    levels: list = field(default_factory=list)


_SCOPE: contextvars.ContextVar = contextvars.ContextVar("space_scope",
                                                        default=None)


def current_space():
    """The active SpaceScope, or None outside a scope (or inside whole())."""
    return _SCOPE.get()


@contextlib.contextmanager
def space_scope(mesh):
    """Run the block on D slabs over the mesh's 'space' axis. A mesh
    without one (or None) leaves everything as it is and yields None."""
    if mesh is None or axis_size(mesh, "space") < 2:
        yield None
        return
    sc = SpaceScope(mesh.get_group("space"), axis_size(mesh, "space"),
                    axis_index(mesh, "space"))
    token = _SCOPE.set(sc)
    try:
        yield sc
    finally:
        _SCOPE.reset(token)


@contextlib.contextmanager
def use_scope(scope):
    """Make `scope` (a SpaceScope, or None for whole tensors) the active
    one for the block: how a recomputation in the backward pass runs in
    the scope its forward ran in."""
    token = _SCOPE.set(scope)
    try:
        yield
    finally:
        _SCOPE.reset(token)


def whole():
    """Leave the space scope for a block that runs on whole tensors."""
    return use_scope(None)


def gather_space(x, dim: int = 2, scope=None):
    """The whole tensor from every rank's slab along `dim` (all_gather).
    Backward: each rank's slice of the gradient summed over the ranks."""
    sc = scope or current_space()
    return _GatherSpace.apply(x, sc.group, dim)


def slice_space(x, dim: int = 2, scope=None):
    """This rank's slab of a whole tensor. Backward: the gradient
    zero-padded to the whole extent."""
    sc = scope or current_space()
    return _SliceSpace.apply(x, sc.n, sc.rank, dim)


def level_layout(extent: int, n: int, num_levels: int) -> list:
    """Which UNet levels run on slabs, for a full-resolution D `extent`
    split n ways (the JAX package's `_replicate_if_degenerate` rule): a
    level whose extent e has e % n != 0 or e // n < 4 runs whole, and so
    does every level below one that runs whole or whose slab is odd (its
    2-voxel max-pool windows would straddle two slabs)."""
    out, e, prev_ok = [], extent, True
    for k in range(num_levels):
        if k:
            prev_ok = out[-1] and (e // n) % 2 == 0
            e //= 2
        out.append(bool(prev_ok and e % n == 0 and e // n >= 4))
    return out


def space_conv(conv, x, scope):
    """A 'SAME' conv module on a slab: a (k-1)//2 halo on D from the
    neighbours, zero padding on the other axes only."""
    import torch.nn.functional as F

    k = conv.kernel_size[0]
    p = (k - 1) // 2
    if p:
        x = halo_exchange(x, p, scope.group)
    pad = (0,) + tuple(conv.padding[1:])
    return F.conv3d(x, conv.weight, conv.bias, conv.stride, pad,
                    conv.dilation, conv.groups)


def spatial_shard_conv_apply(apply_fn, x, mesh, halo: int):
    """Apply a stencil network to this rank's D slab `x` (B, C, D_local,
    H, W) of a volume split over the mesh 'space' axis: the slab plus a
    `halo` from each neighbour goes through `apply_fn`, and every output
    leaf of the padded extent is cropped back to the slab.

    DOMAIN: pure convolution/stencil networks ONLY, and exact only away
    from the global volume edge: stacked SAME convs re-pad zeros per
    layer at the true boundary, while the halo path lets boundary
    influence propagate through the zero halo (within one receptive
    field of the volume edge the results differ). Any cross-volume
    statistic (GroupNorm, global pooling) is computed per slab+halo here,
    NOT globally; for the UNet use `space_scope`, which reduces them over
    the slabs. `halo` must cover the receptive-field half-width. Returns
    the same tree as apply_fn, each full-resolution leaf a slab."""
    sc_group = mesh.get_group("space")
    padded = halo_exchange(x, halo, sc_group)
    out = apply_fn(padded)

    def crop(leaf):
        if torch.is_tensor(leaf) and leaf.dim() >= 3 \
                and leaf.shape[2] == padded.shape[2]:
            return leaf[:, :, halo:leaf.shape[2] - halo]
        return leaf

    if isinstance(out, dict):
        return {k: crop(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(crop(v) for v in out)
    return crop(out)


def slab_of(x, scope, dim: int = 1):
    """This rank's D slab of a whole input (no gradient path), D on `dim`
    (1 for the joiners' channels-last (N, D, H, W, C))."""
    return None if x is None else local_slice(x, scope.n, scope.rank, dim)


def gather_outputs(out: dict, scope, dim: int = 1) -> dict:
    """A joiner's channels-last outputs made whole after a forward in
    `scope`: each feature list level by the scope's `levels`, and every
    other field of 4 or more dims (full resolution, from the final level)
    when level 0 ran on slabs; scalar outputs are whole already."""
    res = {}
    for k, v in out.items():
        if isinstance(v, list):
            L = len(v)
            res[k] = [gather_space(f, dim, scope) if scope.levels[L - 1 - i]
                      else f for i, f in enumerate(v)]
        elif torch.is_tensor(v) and v.dim() >= 4 and scope.levels[0]:
            res[k] = gather_space(v, dim, scope)
        else:
            res[k] = v
    return res
