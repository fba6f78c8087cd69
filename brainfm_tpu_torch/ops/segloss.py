"""The training criterion's segmentation losses (models/criterion.py):
softmax over the labels, then the weighted cross-entropy and the weighted
Dice, forward and backward.

`seg_losses(logits, target, w)` returns (loss_seg_ce, loss_seg_dice) of
the head's logits (S, D, H, W, L), before any softmax, and a target map
(1, D, H, W, L) that broadcasts over the S samples (one-hot, or soft with
`deform_one_hots`); w is the (L,) label weight vector:

  p         = softmax(logits) over L, in at least fp32
  seg_ce    = mean over S x voxels of -sum_l log(max(p_l, 1e-5)) w_l t_l
  seg_dice  = sum over (s, l) of w_l (1 - 2 I_sl / max(U_sl, 1e-5)) / S,
              I_sl = sum_v p t, U_sl = sum_v (p + t)

Clips follow `torch.clamp`: no gradient where p_l < 1e-5 or U_sl < 1e-5,
the whole gradient at an exact tie.

On CPU tensors it is the eager chain (`seg_losses_plain`, which
`cross_entropy` and `dice` spell out, and which the criterion runs on
probabilities). On CUDA tensors it is `SegLoss`, two passes of
csrc/segloss.cu over the logits where they lie, in their own dtype (bf16
under autocast, fp32, or fp64; nothing else is taken): pass 1 forms the
softmax and the sums I, P = sum_v p, T = sum_v t and the cross-entropy's
sum, per block, then adds the blocks in a fixed order; the losses are a few
(S, L) operations on them. Only the logits, the target and I, U are saved.
Pass 2 forms the softmax again and writes dL/dlogits in the logits' dtype.
A voxel's labels must be contiguous and the voxels must lie at one stride,
of L values to MAX_ROW_BYTES (a channel-offset view of the NDHWC head tensor
does; its voxel stride is the head's width); other logits are copied once
into a dense tensor, counted as `layout.copies`. The target is taken
dense. The passes read each run of a tile's rows as the aligned 16-B
vectors around it, up to 15 bytes outside the tensor's values; a vector
that holds a byte of the tensor lies in that byte's page, so this holds
for memory from any allocator (DLPack, `from_blob`), and those bytes are
not used. Each call counts `loss.seg_kernel` (utils/profiling.py).
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from .. import kernels
from ..utils.profiling import count

EPS = 1e-5
_SPATIAL = (1, 2, 3)   # the voxel axes of (S, D, H, W, L)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}
# csrc/segloss.cu: labels a voxel (kMaxLabels), samples a block (kSamples),
# the widest voxel stride in bytes (kMaxRowBytes)
MAX_LABELS = 64
BLOCK_SAMPLES = 4
MAX_ROW_BYTES = 1024
# the passes' grid: about BLOCKS blocks, each at least MIN_VOXELS voxels
BLOCKS = 2048
MIN_VOXELS = 64


# ---- the plain version (the CPU's path, and the kernels' reference) ----

def cross_entropy(p, t, w=1.0):
    """mean over the voxels of -sum over the last axis of
    log(max(p, 1e-5)) * w * t."""
    return torch.mean(-torch.sum(torch.log(p.clamp(min=EPS)) * w * t,
                                 dim=-1))


def dice(p, t, weights=None):
    """sum over (S, labels) of (1 - 2 |p t| / |p + t|)."""
    inter = torch.sum(p * t, dim=_SPATIAL)
    union = torch.sum(p + t, dim=_SPATIAL).clamp(min=EPS)
    d = 1.0 - 2.0 * inter / union
    return torch.sum(d if weights is None else weights * d)


def seg_losses_plain(logits, target, w):
    """(seg_ce, seg_dice) by the eager chain: the softmax of the logits
    lifted to at least fp32, then `cross_entropy` and `dice` / S."""
    p = torch.softmax(logits.to(torch.promote_types(logits.dtype,
                                                    torch.float32)), dim=-1)
    return cross_entropy(p, target, w), dice(p, target, w) / p.shape[0]


def _losses_of_sums(I, U, ce_sum, w, S: int, V: int):
    """(seg_ce, seg_dice) from pass 1's sums: I, U (S, L) and the sum of
    log(max(p, 1e-5)) w t over every voxel and label."""
    return (-ce_sum / (S * V),
            torch.sum(w * (1.0 - 2.0 * I / U.clamp(min=EPS))) / S)


def _coefficients(I, U, w, g_ce, g_dice, S: int, V: int):
    """(a, b, c) of pass 2, from the sums and the losses' upstream
    gradients: dL/dp[s, v, l] = a[s, l] t[v, l] + b[s, l]
    + [p >= 1e-5] c[l] t[v, l] / p."""
    uc = U.clamp(min=EPS)
    gd = g_dice * w / S                # dL / d(1 - 2 I / U) of (s, l)
    a = -2.0 * gd / uc
    b = torch.where(U >= EPS, 2.0 * gd * I / (uc * uc), 0.0)
    c = -g_ce * w / (S * V)
    return a, b, c


# ---- how near the kernels come to the plain version: the yardstick of
# the card's tests and of chip_smoke.py. Each loss within LOSS_RTOL of its
# own value (sums in another order). Each gradient value within one ulp of
# the logits' dtype at its own size, plus GRAD_FLOOR of the largest |value|:
# both form dL/dlogits in fp32 (fp64) from sums taken in other orders, so
# values that cancel to far below their terms differ by the terms'
# rounding, not the result's. ----
LOSS_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
GRAD_FLOOR = {torch.bfloat16: 2.0 ** -16, torch.float32: 2.0 ** -16,
              torch.float64: 2.0 ** -40}
_MANTISSA = {torch.bfloat16: 7, torch.float32: 23, torch.float64: 52}
_SLAB = 1 << 24


def loss_excess(got, want) -> float:
    """The largest gap of the losses `got` to `want` over LOSS_RTOL of the
    wanted loss: <= 0 where they agree."""
    gap = (got.double() - want.double()).abs()
    return float((gap - LOSS_RTOL[want.dtype] * want.double().abs()).max())


def grad_excess(got, want) -> float:
    """The largest gap of the gradient `got` to `want`, each value over one
    ulp of want's dtype at the larger of the two and GRAD_FLOOR of the
    largest |want|: <= 0 where they agree. Compared in slabs of about
    _SLAB values, so the fp64 temporaries stay small beside a 160^3 x 56
    gradient."""
    lo, hi = torch.aminmax(want)
    floor = GRAD_FLOOR[want.dtype] * max(-float(lo), float(hi))
    d = max(range(want.dim()), key=lambda i: want.shape[i])
    step = max(1, want.shape[d] * _SLAB // max(1, want.numel()))
    worst = -math.inf
    for g, w in zip(got.split(step, d), want.split(step, d)):
        g, w = g.double(), w.double()
        big = torch.maximum(g.abs(), w.abs())
        ulp = torch.ldexp(torch.ones_like(big),
                          torch.frexp(big)[1] - 1 - _MANTISSA[want.dtype])
        worst = max(worst, float(((g - w).abs() - ulp - floor).max()))
    return worst


# ---- the kernels' wrapper ----

def _voxel_stride(t):
    """The voxel stride of (N, ..., L) t whose labels are contiguous and
    whose voxels lie at one stride, else None."""
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        return None
    xv = want = None
    for n, st in zip(reversed(t.shape[1:-1]), reversed(t.stride()[1:-1])):
        if n == 1:
            continue
        if want is None:
            xv = want = st
        elif st != want:
            return None
        want *= n
    return t.shape[-1] if xv is None else xv


def _check(logits, target, w):
    """The CUDA operands checked and laid out for the kernels: (x, t, w,
    S, V, L, the voxel stride of x)."""
    if logits.dtype not in _DTYPE_CODE:
        raise TypeError(f"seg_losses: logits of dtype {logits.dtype}; one "
                        "of bfloat16, float32, float64 on CUDA")
    if logits.dim() != 5 or target.dim() != 5:
        raise ValueError("seg_losses: logits (S, D, H, W, L) and a target "
                         f"(1, D, H, W, L); got {tuple(logits.shape)} and "
                         f"{tuple(target.shape)}")
    S, L = logits.shape[0], logits.shape[-1]
    if tuple(target.shape) != (1,) + tuple(logits.shape[1:]):
        raise ValueError(f"seg_losses: target {tuple(target.shape)} does "
                         f"not broadcast over logits {tuple(logits.shape)} "
                         "as one (1, D, H, W, L) map")
    if not 1 <= L <= MAX_LABELS:
        raise ValueError(f"seg_losses: {L} labels; the kernels take 1 to "
                         f"{MAX_LABELS}")
    if tuple(w.shape) != (L,):
        raise ValueError(f"seg_losses: weights {tuple(w.shape)}, want "
                         f"({L},)")
    if any(a.device != logits.device for a in (target, w)):
        raise ValueError("seg_losses: logits, target and weights on "
                         f"{logits.device}, {target.device}, {w.device}")
    V = math.prod(logits.shape[1:-1])
    if S == 0 or V == 0:
        raise ValueError(f"seg_losses: empty logits {tuple(logits.shape)}")
    xv = _voxel_stride(logits)
    if xv is None or not L <= xv <= MAX_ROW_BYTES // logits.element_size():
        count("layout.copies")
        logits = logits.contiguous()
        xv = L
    acc = torch.promote_types(logits.dtype, torch.float32)
    return (logits, target.to(acc).contiguous(), w.to(acc).contiguous(), S,
            V, L, xv)


def _grid(S: int, V: int) -> tuple[int, int]:
    """(vchunk, chunks): each group of BLOCK_SAMPLES samples in `chunks`
    blocks of `vchunk` voxels."""
    groups = -(-S // BLOCK_SAMPLES)
    chunks = max(1, min(-(-BLOCKS // groups), V // MIN_VOXELS))
    vchunk = -(-V // chunks)
    return vchunk, -(-V // vchunk)


class SegLoss(torch.autograd.Function):
    """(seg_ce, seg_dice) of CUDA logits: pass 1 forward, pass 2 backward
    (csrc/segloss.cu)."""

    @staticmethod
    def forward(ctx, logits, target, w):
        x, t, w, S, V, L, xv = _check(logits, target, w)
        acc = t.dtype
        vchunk, chunks = _grid(S, V)
        rows = 2 * S * L + L + -(-S // BLOCK_SAMPLES)
        part = torch.empty((rows, chunks), dtype=acc, device=x.device)
        out = torch.empty(rows, dtype=acc, device=x.device)
        kernels.launch("seg_loss_fwd", x.data_ptr(), t.data_ptr(),
                       w.data_ptr(), part.data_ptr(), out.data_ptr(),
                       _DTYPE_CODE[x.dtype], S, V, L, x.stride(0), xv, vchunk,
                       chunks)
        count("loss.seg_kernel")
        SL = S * L
        I = out[:SL].view(S, L)
        U = out[SL:2 * SL].view(S, L) + out[2 * SL:2 * SL + L]
        ctx.save_for_backward(x, t, w, I, U)
        ctx.dims = (S, V, L, xv, vchunk, chunks)
        ctx.shape = logits.shape
        return _losses_of_sums(I, U, out[2 * SL + L:].sum(), w, S, V)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_ce, g_dice):
        x, t, w, I, U = ctx.saved_tensors
        S, V, L, xv, vchunk, chunks = ctx.dims
        a, b, c = (v.contiguous() for v in _coefficients(
            I, U, w, g_ce, g_dice, S, V))
        dx = torch.empty((S, V, L), dtype=x.dtype, device=x.device)
        kernels.launch("seg_loss_bwd", x.data_ptr(), t.data_ptr(),
                       a.data_ptr(), b.data_ptr(), c.data_ptr(), dx.data_ptr(),
                       _DTYPE_CODE[x.dtype], S, V, L, x.stride(0), xv, vchunk,
                       chunks)
        return dx.view(ctx.shape), None, None


def seg_losses(logits, target, w):
    """(loss_seg_ce, loss_seg_dice) of the head's logits (module
    docstring): the eager chain on CPU tensors, the kernels on CUDA ones."""
    if logits.device.type == "cpu":
        return seg_losses_plain(logits, target, w)
    if logits.device.type != "cuda":
        raise ValueError(f"seg_losses: logits on {logits.device}; CPU or "
                         "CUDA")
    return SegLoss.apply(logits, target, w)
