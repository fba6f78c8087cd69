"""GroupNorm in sums-and-composite-affine form with analytic backwards
(port of brainfm_tpu/models/unet3d.py `_fgn_stats`, `_fused_groupnorm`
and `_pair_groupnorm`), on (N, C, ...) tensors.

The formulas are the JAX package's: statistics in
`promote_types(x.dtype, float32)` (fp32 for bf16 and fp32 inputs, fp64
for fp64), the fast variance E[x^2] - E[x]^2 and rsqrt, per-channel
coefficients y = x * a + b with the output in x's dtype; the backward
dx = dy * P + x * Q + R combined in x's dtype (tests/test_phase_upconv.py's
TOLERANCE NOTE: bf16 coefficient rounding under autocast, never an fp32
copy of the activation). Only x (in its own dtype), the scale and the
(B, G) statistics are saved for the backward. The scale and bias are used
in the statistics type; autocast does not touch these functions.

`fused_group_norm(..., group=)` is the same function on one rank's D
slab of a volume split into equal slabs over a process group (the space
scope of parallel/spatial.py, where the JAX SingleConv keeps
`_fused_groupnorm` under GSPMD): one all_reduce of K3's (2, N, C) sums in
the forward and one in the backward, nothing full-size exchanged.

The pair form normalizes the virtual concat([enc, nearest_up2(z)]) without
materializing it: the coarse part's sums carry the 8x repeat weight, and
its backward the 16 * D2 and 8 * D1 terms.

The full-size passes are three custom operators (`torch.ops.brainfm.*`,
visible to selective checkpointing, `FlopCounterMode` and
`TorchDispatchMode`s), each launching a kernel of csrc/groupnorm.cu on
CUDA tensors and taking its plain version on CPU tensors only:

  K3 chan_sums(u, v)          (2, N, C): sum(u), sum(u * v) per channel
  K4 chan_affine(x, a, b)     x * a + b per channel, stored in x's dtype
  K5 chan_affine3(dy, x, P, Q, R)   dy * P + x * Q + R in x's dtype

On the card the kernels take one layout, channels-last (N, ..., C) dense
(NDHWC, `channels_last_3d`, the layout the 3-D network runs in there; a
tensor with one channel or one voxel is one already). An operand that is
contiguous (N, C, ...) instead, such as an NCDHW tensor from a caller
outside the network, is copied once into channels-last and the copy
counted as `layout.copies` (utils/profiling.py); a view that is neither
raises. The outputs are channels-last. The CPU's plain versions take
either layout. The formulas, the statistics type and what is saved for
the backward do not depend on the layout. The (B, C) -> (B, G) algebra
between the passes is a few tiny tensors in plain PyTorch.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch import Tensor

from .. import kernels
from ..utils.profiling import count

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}
# K3's stage-1 grid: about K3_BLOCKS blocks over the samples, each at least
# K3_MIN_VOXELS voxels and K3_MIN_ELEMENTS elements
K3_BLOCKS = 1024
K3_MIN_VOXELS = 32
K3_MIN_ELEMENTS = 4096


def num_groups_of(channels: int, num_groups: int) -> int:
    """The JAX package's `_num_groups`: fewer channels than groups means
    one group."""
    if channels < num_groups:
        return 1
    if channels % num_groups:
        raise ValueError(f"{channels} channels in {num_groups} groups")
    return num_groups


def stats_dtype(dtype):
    return torch.promote_types(dtype, torch.float32)


def _per_channel(t, ndim):
    """(N, C) coefficients shaped to broadcast over an (N, C, ...) tensor."""
    return t.reshape(t.shape + (1,) * (ndim - 2))


# ---- the plain versions (the CPU's path, and the kernels' reference) ----

def chan_sums_plain(u, v=None):
    """(2, N, C) in the statistics type: sum(u) and sum(u * v) over the
    spatial axes of (N, C, ...) tensors; v None means v = u."""
    sdt = stats_dtype(u.dtype)
    u32 = u.to(sdt)
    v32 = u32 if v is None else v.to(sdt)
    dims = tuple(range(2, u.dim()))
    return torch.stack([u32.sum(dims), (u32 * v32).sum(dims)])


def chan_affine_plain(x, a, b):
    """x * a + b per (sample, channel) in a's type, stored in x's dtype."""
    return (x.to(a.dtype) * _per_channel(a, x.dim())
            + _per_channel(b, x.dim())).to(x.dtype)


def chan_affine3_plain(dy, x, P, Q, R):
    """dy * P + x * Q + R per (sample, channel), every operation in x's
    dtype."""
    n = x.dim()
    return dy * _per_channel(P, n) + x * _per_channel(Q, n) \
        + _per_channel(R, n)


# ---- the kernels' wrappers ----

def _to_last(t):
    """t (N, C, ...) channels-last dense: itself, or the copy of a
    contiguous t, counted as `layout.copies`."""
    last = t.movedim(1, -1)
    if last.is_contiguous():
        return t
    count("layout.copies")
    return last.contiguous().movedim(-1, 1)


def _check(name, *tensors):
    """The CUDA operands, x (the activation) last, checked for device,
    dtype, shape and strides, each channels-last (`_to_last`). Returns
    (operands, N, S, C)."""
    x = tensors[-1]
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in tensors):
        raise ValueError(f"{name}: tensors on "
                         f"{[str(t.device) for t in tensors]}; all must be "
                         "on one CUDA device or all on the CPU")
    if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype
                                         for t in tensors):
        raise TypeError(f"{name}: dtypes {[t.dtype for t in tensors]}; one "
                        "of bfloat16, float32, float64 for all")
    if x.dim() < 3 or any(t.shape != x.shape for t in tensors):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in tensors]}"
                         "; one (N, C, ...) shape for all")
    if not all(t.is_contiguous() or t.movedim(1, -1).is_contiguous()
               for t in tensors):
        raise ValueError(f"{name}: every tensor must be channels-last (N, "
                         "..., C) dense or contiguous (N, C, ...); strides "
                         f"{[t.stride() for t in tensors]}")
    N, C = x.shape[:2]
    return tuple(map(_to_last, tensors)), N, math.prod(x.shape[2:]), C


def _coeffs(name, x, dtype, *coeffs):
    N, C = x.shape[:2]
    for t in coeffs:
        if (t.device != x.device or t.dtype != dtype
                or tuple(t.shape) != (N, C) or not t.is_contiguous()):
            raise ValueError(f"{name}: coefficients must be contiguous "
                             f"({N}, {C}) {dtype} on {x.device}; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _k3_grid(N: int, C: int, S: int) -> tuple[int, int]:
    """(chunk, chunks) of K3's stage 1: each sample in `chunks` blocks of
    `chunk` voxels."""
    least = max(K3_MIN_VOXELS, -(-K3_MIN_ELEMENTS // C))
    chunks = max(1, min(-(-K3_BLOCKS // max(N, 1)), S // least))
    chunk = -(-max(S, 1) // chunks)
    return chunk, -(-max(S, 1) // chunk)


def _sums_cuda(u, v):
    ops, N, S, C = _check("chan_sums", *((u,) if v is None else (u, v)))
    u, v = ops if v is not None else (ops[0], None)
    sdt = stats_dtype(u.dtype)
    chunk, chunks = _k3_grid(N, C, S)
    part = torch.empty((N * C, chunks, 2), dtype=sdt, device=u.device)
    out = torch.empty((2, N, C), dtype=sdt, device=u.device)
    kernels.launch("chan_sums", u.data_ptr(),
                   None if v is None else v.data_ptr(), part.data_ptr(),
                   out.data_ptr(), _DTYPE_CODE[u.dtype], N, S, C, chunk,
                   chunks)
    return out


def _on_cpu(*tensors):
    return all(t.device.type == "cpu" for t in tensors)


@torch.library.custom_op("brainfm::chan_sums", mutates_args=())
def chan_sums(u: Tensor, v: Optional[Tensor] = None) -> Tensor:
    """K3: (2, N, C) sum(u) and sum(u * v) per (sample, channel) in the
    statistics type; v None means v = u."""
    if _on_cpu(u, *(() if v is None else (v,))):
        return chan_sums_plain(u, v)
    return _sums_cuda(u, v)


@chan_sums.register_fake
def _(u, v=None):
    return u.new_empty((2,) + tuple(u.shape[:2]),
                       dtype=stats_dtype(u.dtype))


@torch.library.custom_op("brainfm::chan_affine", mutates_args=())
def chan_affine(x: Tensor, a: Tensor, b: Tensor) -> Tensor:
    """K4: x * a + b per (sample, channel), a and b (N, C) in the
    statistics type, the result in x's dtype."""
    if _on_cpu(x, a, b):
        return chan_affine_plain(x, a, b)
    (x,), N, S, C = _check("chan_affine", x)
    _coeffs("chan_affine", x, stats_dtype(x.dtype), a, b)
    y = torch.empty_like(x)
    kernels.launch("chan_affine", x.data_ptr(), a.data_ptr(), b.data_ptr(),
                   y.data_ptr(), _DTYPE_CODE[x.dtype], N, S, C)
    return y


@chan_affine.register_fake
def _(x, a, b):
    return torch.empty_like(x)


@torch.library.custom_op("brainfm::chan_affine3", mutates_args=())
def chan_affine3(dy: Tensor, x: Tensor, P: Tensor, Q: Tensor,
                 R: Tensor) -> Tensor:
    """K5: dy * P + x * Q + R per (sample, channel), P, Q, R (N, C) in x's
    dtype, every operation rounded to x's dtype."""
    if _on_cpu(dy, x, P, Q, R):
        return chan_affine3_plain(dy, x, P, Q, R)
    (dy, x), N, S, C = _check("chan_affine3", dy, x)
    _coeffs("chan_affine3", x, x.dtype, P, Q, R)
    dx = torch.empty_like(x)
    kernels.launch("chan_affine3", dy.data_ptr(), x.data_ptr(), P.data_ptr(),
                   Q.data_ptr(), R.data_ptr(), dx.data_ptr(),
                   _DTYPE_CODE[x.dtype], N, S, C)
    return dx


@chan_affine3.register_fake
def _(dy, x, P, Q, R):
    return torch.empty_like(x)


# ---- the GroupNorms ----

def _group_stats(s1, s2, groups, count, eps):
    """(gmean, inv) (B, G) from per-channel sums (B, C) over `count`
    elements a group."""
    B = s1.shape[0]
    gmean = s1.reshape(B, groups, -1).sum(-1) / count
    gmean2 = s2.reshape(B, groups, -1).sum(-1) / count
    return gmean, torch.rsqrt(gmean2 - gmean * gmean + eps)


def _affine_coeffs(gmean, inv, scale, bias, gsize):
    """Per-channel (a, b) of y = x * a + b, (B, C)."""
    s = scale[None]
    a = inv.repeat_interleave(gsize, -1) * s
    b = bias[None] - (gmean * inv).repeat_interleave(gsize, -1) * s
    return a.contiguous(), b.contiguous()


def _sum_over(group, s, extents=()):
    """The (2, N, C) sums `s` summed over the ranks of `group` in one
    all_reduce of a fresh contiguous tensor. `extents` (this rank's slab
    shape) ride along: every rank's must be the same, so that each slab
    counts as many voxels (`level_layout` makes it so); the check is
    asynchronous on the card."""
    mine = s.new_tensor(extents)
    flat = torch.cat([s.reshape(-1), mine])
    dist.all_reduce(flat, group=group)
    if extents:
        torch._assert_async(
            (flat[s.numel():] == mine * dist.get_world_size(group)).all(),
            f"slabs of unequal extents: this rank's {tuple(extents)}")
    return flat[:s.numel()].view(s.shape)


def _slab_count(x, group):
    """Elements of one channel over every rank's slab of x (N, C, ...)."""
    n = 1 if group is None else dist.get_world_size(group)
    return math.prod(x.shape[2:]) * n


def group_stats(x, num_groups: int, eps: float = 1e-5, group=None):
    """`_fgn_stats`: (gmean, inv) of shape (B, groups) in the statistics
    type, from one K3 pass over x (N, C, ...); with a process `group`,
    over every rank's equal slab of x (the sums summed over the group)."""
    C = x.shape[1]
    groups = num_groups_of(C, num_groups)
    s = chan_sums(x)
    if group is not None:
        s = _sum_over(group, s, x.shape[2:])
    return _group_stats(s[0], s[1], groups,
                        _slab_count(x, group) * (C // groups), eps)


class _FusedGroupNorm(torch.autograd.Function):
    """`_fused_groupnorm`; with a process `group`, on this rank's slab of
    a volume split into equal slabs over the group: the statistics are the
    whole volume's (K3's sums summed over the group), the scale's and
    bias's gradients this slab's share (the caller sums them over the
    ranks), dx the whole volume's (the backward's sums summed again)."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, group):
        C = x.shape[1]
        groups = num_groups_of(C, num_groups)
        sdt = stats_dtype(x.dtype)
        gmean, inv = group_stats(x, num_groups, eps, group)
        a, b = _affine_coeffs(gmean, inv, scale.to(sdt), bias.to(sdt),
                              C // groups)
        ctx.save_for_backward(x, scale, gmean, inv)
        ctx.groups, ctx.group = groups, group
        return chan_affine(x, a, b)

    @staticmethod
    def backward(ctx, dy):
        x, scale, gmean, inv = ctx.saved_tensors
        groups = ctx.groups
        B, C = x.shape[:2]
        gsize = C // groups
        sdt = stats_dtype(x.dtype)
        N = _slab_count(x, ctx.group) * gsize
        s32 = scale.to(sdt)[None]
        gm = gmean.repeat_interleave(gsize, -1)
        invc = inv.repeat_interleave(gsize, -1)
        s = chan_sums(dy, x)
        s_dy, ctr = s[0], s[1] - gm * s[0]
        dscale = (ctr * invc).sum(0)
        dbias = s_dy.sum(0)
        dx = None
        if ctx.needs_input_grad[0]:
            if ctx.group is not None:
                s = _sum_over(ctx.group, s)
                s_dy, ctr = s[0], s[1] - gm * s[0]
            m1 = (s_dy * s32).reshape(B, groups, gsize).sum(-1) / N
            m2 = (ctr * s32).reshape(B, groups, gsize).sum(-1) * inv / N
            P = invc * s32
            Q = (-(inv * inv * m2)).repeat_interleave(gsize, -1)
            R = (-inv * m1 + gmean * inv * inv * m2).repeat_interleave(
                gsize, -1)
            dt = x.dtype
            dx = chan_affine3(dy, x, P.to(dt).contiguous(),
                              Q.to(dt).contiguous(), R.to(dt).contiguous())
        return (dx, dscale.to(scale.dtype), dbias.to(scale.dtype), None,
                None, None)


def fused_group_norm(x, scale, bias, num_groups: int, eps: float = 1e-5,
                     group=None):
    """`_fused_groupnorm`: GroupNorm of x (N, C, ...) with per-channel
    `scale` and `bias`, output in x's dtype, analytic backward (K3, K4 in
    the forward; K3, K5 in the backward). With a process `group`, x is
    this rank's slab of a volume split into equal slabs over the group:
    one all_reduce of the (2, N, C) sums each way, nothing full-size
    exchanged; the scale's and bias's gradients are the slab's share."""
    return _FusedGroupNorm.apply(x, scale, bias, num_groups, eps, group)


class _PairGroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, enc, z, scale, bias, num_groups, eps):
        ce, cz = enc.shape[1], z.shape[1]
        C = ce + cz
        groups = num_groups_of(C, num_groups)
        gsize = C // groups
        sdt = stats_dtype(enc.dtype)
        n_fine = math.prod(enc.shape[2:])
        se, sz = chan_sums(enc), chan_sums(z) * 8.0
        s1 = torch.cat([se[0], sz[0]], -1)
        s2 = torch.cat([se[1], sz[1]], -1)
        gmean, inv = _group_stats(s1, s2, groups, n_fine * gsize, eps)
        a, b = _affine_coeffs(gmean, inv, scale.to(sdt), bias.to(sdt), gsize)
        ctx.save_for_backward(enc, z, scale, gmean, inv)
        ctx.groups = groups
        return (chan_affine(enc, a[:, :ce].contiguous(),
                            b[:, :ce].contiguous()),
                chan_affine(z, a[:, ce:].contiguous(),
                            b[:, ce:].contiguous()))

    @staticmethod
    def backward(ctx, ge, gz):
        enc, z, scale, gmean, inv = ctx.saved_tensors
        groups = ctx.groups
        ce = enc.shape[1]
        B, C = enc.shape[0], ce + z.shape[1]
        gsize = C // groups
        sdt = stats_dtype(enc.dtype)
        N = math.prod(enc.shape[2:]) * gsize
        s32 = scale.to(sdt)[None]
        ue, uz = chan_sums(ge, enc), chan_sums(gz, z)
        u1 = torch.cat([ue[0], uz[0]], -1)
        u2 = torch.cat([ue[1], uz[1]], -1)
        invc = inv.repeat_interleave(gsize, -1)
        ctr = u2 - gmean.repeat_interleave(gsize, -1) * u1
        dscale = (invc * ctr).sum(0)
        dbias = u1.sum(0)
        inv3 = inv * inv * inv
        T = (s32 * ctr).reshape(B, groups, gsize).sum(-1)
        W = (s32 * u1).reshape(B, groups, gsize).sum(-1)
        D1 = ((-inv * W + T * gmean * inv3) / N).repeat_interleave(gsize, -1)
        D2 = ((-0.5 * T * inv3) / N).repeat_interleave(gsize, -1)
        A = invc * s32
        de = dz = None
        if ctx.needs_input_grad[0]:
            dt = enc.dtype
            de = chan_affine3(ge, enc, A[:, :ce].to(dt).contiguous(),
                              (2.0 * D2[:, :ce]).to(dt).contiguous(),
                              D1[:, :ce].to(dt).contiguous())
        if ctx.needs_input_grad[1]:
            dt = z.dtype
            dz = chan_affine3(gz, z, A[:, ce:].to(dt).contiguous(),
                              (16.0 * D2[:, ce:]).to(dt).contiguous(),
                              (8.0 * D1[:, ce:]).to(dt).contiguous())
        return (de, dz, dscale.to(scale.dtype), dbias.to(scale.dtype), None,
                None)


def pair_group_norm(enc, z, scale, bias, num_groups: int, eps: float = 1e-5):
    """`_pair_groupnorm`: GroupNorm over the virtual
    concat([enc, nearest_up2(z)]) of enc (N, Ce, 2D, 2H, 2W) and z
    (N, Cz, D, H, W), returned as the pair (enc_out, z_out) in their
    dtypes; `scale` and `bias` have Ce + Cz channels."""
    return _PairGroupNorm.apply(enc, z, scale, bias, num_groups, eps)
