"""The criterion's segmentation losses from the head's logits
(brainfm_tpu_torch/ops/segloss.py) on the CPU: the plain path against the
eager chain the criterion ran on processed probabilities, and the two
kernel passes' arithmetic (their sums, the losses of them and the backward's
coefficients, written here in PyTorch) against its autograd gradient, in
fp64. The kernels themselves are held to the plain path on the card by
tests/test_torch_cuda.py. No JAX.
"""

import math

import numpy as np
import pytest
import torch

from brainfm_tpu_torch import kernels
from brainfm_tpu_torch.models.build import process_outputs
from brainfm_tpu_torch.models.criterion import _seg_weights, make_criterion
from brainfm_tpu_torch.ops import segloss

EPS = 1e-5
SHAPE = (5, 4, 6)    # (D, H, W)


def _eager(logits, target, w):
    """The criterion's chain before this module: the processors' softmax
    of the logits lifted to fp32 (fp64 stays fp64), then its `ce` and
    `_dice` / S, as written there."""
    p = torch.softmax(logits.float() if logits.dtype == torch.bfloat16
                      else logits, dim=-1)
    ce = torch.mean(-torch.sum(torch.log(p.clamp(min=1e-5)) * w * target,
                               dim=-1))
    inter = torch.sum(p * target, dim=(1, 2, 3))
    union = torch.sum(p + target, dim=(1, 2, 3)).clamp(min=1e-5)
    return ce, torch.sum(w * (1.0 - 2.0 * inter / union)) / p.shape[0]


def _passes(logits, target, w, g_ce, g_dice, broken=None):
    """The kernels' arithmetic: pass 1's sums, the losses of them, pass 2's
    dL/dlogits from `_coefficients`; `broken` leaves a term out of it."""
    S, L = logits.shape[0], logits.shape[-1]
    V = math.prod(logits.shape[1:-1])
    p = torch.softmax(logits.double(), -1).reshape(S, V, L)
    t = target.double().reshape(V, L)
    I, U = (p * t).sum(1), p.sum(1) + t.sum(0)
    ce_sum = (torch.log(p.clamp(min=EPS)) * w * t).sum()
    losses = segloss._losses_of_sums(I, U, ce_sum, w, S, V)
    a, b, c = segloss._coefficients(I, U, w, g_ce, g_dice, S, V)
    if broken == "no_dice_b":
        b = torch.zeros_like(b)
    pg = p * (a[:, None] * t + b[:, None]) + torch.where(p >= EPS, c * t, 0)
    dx = pg - p * pg.sum(-1, keepdim=True)
    if broken == "no_softmax_sum":
        dx = pg
    if broken == "non_targets_zeroed":
        dx = dx * (t > 0)
    return losses, dx.reshape(logits.shape)


def _at_eps(rng, L):
    """One voxel's fp64 logits whose softmax holds exactly 1e-5 at label
    0 and far less at labels 1 and 2: label 0's logit bisected over the
    doubles, label 3's moved until a bisection lands on the tie."""
    x = rng.standard_normal(L)
    x[1], x[2] = -40.0, -60.0
    x3 = x[3]

    def p0(v):
        return float(torch.softmax(torch.from_numpy(v), 0)[0])

    for trial in range(4096):
        x[3] = x3 + trial * 1e-9
        r = np.exp(x[1:]).sum()
        lo, hi = math.log(0.99e-5 * r), math.log(1.01e-5 * r)
        while (lo + hi) / 2 not in (lo, hi):
            mid = (lo + hi) / 2
            lo, hi = (mid, hi) if p0(np.r_[mid, x[1:]]) < 1e-5 else (lo, mid)
        for x[0] in (lo, hi):
            if p0(x) == 1e-5:
                return x
    raise AssertionError("no tie found")


def _case(name):
    """(leaf, view, target, w) of a case, fp64 unless said otherwise: the
    logits are view(leaf)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    S = {"S1": 1, "S2": 2}.get(name, 4)
    L = 56 if name in ("lesion", "offset_view") else 9
    x = rng.standard_normal((S,) + SHAPE + (L,)) * 3
    lab = rng.integers(0, L, SHAPE)
    t = np.eye(L)[lab][None]
    w = np.full(L, 1.0 / L)
    if name == "clamp":
        x[0, 0, 0, 0] = _at_eps(rng, L)
        x[1, 0, 0, 1, 1] = 80.0      # p of every other label far under
    if name == "absent":
        t[..., 3] = 0.0              # label 3 in neither target nor p
        x[..., 3] = -60.0
    if name == "soft":
        t = rng.dirichlet(np.full(L, 0.3), SHAPE)[None]
    if name == "lesion":
        labels = list(range(L))
        labels[7] = 77
        w = _seg_weights(L, labels, 5.0).astype(np.float64)
        lab[1:3] = 7
        t = np.eye(L)[lab][None]
    logits = torch.from_numpy(x)
    if name == "offset_view":
        # the channel-offset view of a 72-wide NDHWC head tensor, in bf16
        head = torch.from_numpy(rng.standard_normal((S, 72) + SHAPE) * 3)
        head = head.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last_3d)
        return (head, lambda h: h.narrow(1, 5, L).movedim(1, -1),
                torch.from_numpy(t).float(), torch.from_numpy(w).float())
    return logits, lambda v: v, torch.from_numpy(t), torch.from_numpy(w)


CASES = ["clamp", "absent", "soft", "lesion", "S1", "S2", "offset_view"]


@pytest.mark.parametrize("name", CASES)
def test_seg_losses_match_the_eager_chain(name):
    leaf, view, target, w = _case(name)
    logits = view(leaf)
    launched = dict(kernels.LAUNCHES)
    g = (torch.tensor(0.7, dtype=torch.float64),
         torch.tensor(1.3, dtype=torch.float64))

    def grad_of(fn):
        x = leaf.detach().requires_grad_(True)
        losses = fn(view(x), target, w)
        (dx,) = torch.autograd.grad(
            g[0].to(losses[0].dtype) * losses[0]
            + g[1].to(losses[1].dtype) * losses[1], x)
        return [float(v.detach()) for v in losses], view(dx)

    want, want_dx = grad_of(_eager)
    got, got_dx = grad_of(segloss.seg_losses)
    assert kernels.LAUNCHES == launched         # the CPU takes no kernel
    assert got == want and torch.equal(got_dx, want_dx)
    assert got_dx.dtype == logits.dtype

    # the kernels' arithmetic, in fp64, against the chain's autograd
    x64 = logits.detach().double().requires_grad_(True)
    t64, w64 = target.double(), w.double()
    ref = _eager(x64, t64, w64)
    (ref_dx,) = torch.autograd.grad(g[0] * ref[0] + g[1] * ref[1], x64)
    losses, dx = _passes(x64.detach(), t64, w64, *g)
    for a, b in zip(losses, ref):
        assert float(a) == pytest.approx(float(b.detach()), rel=1e-12)
    tol = 1e-12 * float(ref_dx.abs().max())
    assert float((dx - ref_dx).abs().max()) <= tol
    if name == "clamp":   # the tie passes its gradient, under it none
        p = torch.softmax(x64.detach(), -1)
        assert float(p[0, 0, 0, 0, 0]) == 1e-5
        assert bool((p < 1e-5).any())
    if name == "absent":  # the union of label 3 is clamped
        assert bool(((torch.softmax(x64.detach(), -1)[..., 3].sum((1, 2, 3))
                      + t64[..., 3].sum()) < 1e-5).all())


def _cfg(tasks):
    from brainfm_tpu_torch.config import AttrDict

    return AttrDict.from_nested({
        "tasks": tasks, "n_labels": 9,
        "label_list_segmentation_with_csf": [0, 2, 3, 4, 77, 5, 6, 7, 8],
        "relative_weight_lesions": 4.0, "losses": {},
        "weights": {"seg_ce": 1.0, "seg_dice": 1.0}})


@pytest.mark.parametrize("S", [1, 2, 4])
def test_criterion_takes_logits_or_probabilities(S):
    """loss_fn on the logits, as process_outputs leaves them for the train
    step, equals loss_fn on the processors' probabilities, bitwise on the
    CPU."""
    rng = np.random.default_rng(S)
    x = torch.from_numpy(rng.standard_normal((S,) + SHAPE + (9,)))
    t = {"segmentation": torch.from_numpy(
        np.eye(9)[rng.integers(0, 9, SHAPE)][None])}
    cfg = _cfg(["segmentation"])
    _, _, fn = make_criterion(cfg)
    for_loss = process_outputs(None, {"segmentation": x}, cfg, for_loss=True)
    assert list(for_loss) == ["segmentation_logits"]
    by_logits = fn(for_loss, t, {})
    by_p = fn(process_outputs(None, {"segmentation": x}, cfg), t, {})
    assert list(by_logits) == list(by_p) == ["loss_seg_ce", "loss_seg_dice"]
    for k in by_p:
        assert torch.equal(by_logits[k], by_p[k])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("tasks", [["segmentation", "pathology"],
                                   ["pathology"]])
def test_process_outputs_for_the_criterion(dtype, tasks):
    """for_loss lifts each floating output, a feature list's too, to at
    least fp32 before the processors, and passes a segmentation task's
    head output on as it is, as its logits."""
    g = torch.Generator().manual_seed(0)
    out = {k: torch.randn((2,) + SHAPE + (c,), generator=g).to(dtype)
           for k, c in (("segmentation", 9), ("pathology", 1))}
    out["feat"] = [torch.randn((2, 3), generator=g).to(dtype)]
    got = process_outputs(None, out, _cfg(tasks), for_loss=True)
    lift = torch.promote_types(dtype, torch.float32)
    assert got["feat"][0].dtype == got["pathology"].dtype == lift
    assert torch.equal(got["pathology"],
                       torch.sigmoid(out["pathology"].to(lift)))
    if "segmentation" in tasks:
        assert "segmentation" not in got
        assert got["segmentation_logits"] is out["segmentation"]
    else:
        assert "segmentation_logits" not in got
        assert torch.equal(got["segmentation"], out["segmentation"].to(lift))


def _strided(kind):
    """(logits, the voxel stride the kernels are given, or None for a
    copy)."""
    x = torch.zeros((2, 64) + SHAPE).contiguous(
        memory_format=torch.channels_last_3d)
    if kind == "head_view":
        return x.narrow(1, 4, 56).movedim(1, -1), 64
    if kind == "dense":
        return torch.zeros((2,) + SHAPE + (56,)), 56
    if kind == "ncdhw":
        return torch.zeros((2, 56) + SHAPE).movedim(1, -1), None
    view = x.narrow(1, 4, 56).movedim(1, -1)
    if kind == "one_voxel_row":   # W = 1: the H axis sets the stride
        return view[..., :1, :], 64 * SHAPE[2]
    if kind == "every_other_w":   # still one stride: 2 x 64
        return view[:, :, :, ::2], 128
    if kind == "every_other_h":   # rows of W voxels with gaps between
        return view[:, :, ::2], None
    if kind == "overlapping_rows":   # one stride, under L
        return torch.zeros(1024).as_strided((2,) + SHAPE + (56,),
                                            (0, 192, 48, 8, 1)), 8
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["head_view", "dense", "ncdhw",
                                  "one_voxel_row", "every_other_w",
                                  "every_other_h", "overlapping_rows"])
def test_voxel_stride_of_logits(kind):
    x, want = _strided(kind)
    assert segloss._voxel_stride(x) == want
    t = torch.zeros((1,) + tuple(x.shape[1:]))
    _, _, _, S, V, L, xv = segloss._check(x, t, torch.ones(56))
    assert (S, V, L) == (2, math.prod(x.shape[1:-1]), 56)
    # a stride under L values or over the kernels' widest row is copied
    # dense too
    fits = want is not None and 56 <= want <= segloss.MAX_ROW_BYTES // 4
    assert xv == (want if fits else 56)


@pytest.mark.parametrize("S,V", [(1, 1), (2, 63), (4, 160 ** 3),
                                 (2, 160 ** 3), (9, 1000)])
def test_kernel_grid_covers_the_voxels(S, V):
    vchunk, chunks = segloss._grid(S, V)
    groups = -(-S // segloss.BLOCK_SAMPLES)
    assert vchunk * chunks >= V > vchunk * (chunks - 1)
    assert chunks * groups <= segloss.BLOCKS + groups


@pytest.mark.parametrize("bad", ["fp16", "labels", "target", "weights",
                                 "dims"])
def test_kernel_wrapper_refuses(bad):
    x = torch.zeros((2,) + SHAPE + (56,))
    t = torch.zeros((1,) + SHAPE + (56,))
    w = torch.ones(56)
    if bad == "fp16":
        x = x.half()
    if bad == "labels":
        x, t, w = (torch.zeros(a.shape[:-1] + (65,)) for a in (x, t, w))
    if bad == "target":
        t = torch.zeros((2,) + SHAPE + (56,))
    if bad == "weights":
        w = torch.ones(55)
    if bad == "dims":
        x, t = x[:, 0], t[:, 0]
    with pytest.raises((TypeError, ValueError)):
        segloss._check(x, t, w)


@pytest.mark.parametrize("broken", [None, "no_dice_b", "no_softmax_sum",
                                    "non_targets_zeroed"])
def test_yardstick_holds_each_term_of_the_gradient(broken):
    """ops/segloss.py's yardstick (`loss_excess`, `grad_excess`) on
    chip_smoke's kind of inputs (bf16 logits of 3 N(0, 1), a one-hot
    target, S = 4, 56 labels): the passes' arithmetic rounded to bf16 lies
    within it of the eager chain's bf16 gradient, and one without Dice's
    constant term, without the softmax backward's sum or with the
    gradients of the other labels zeroed does not; a loss 2e-5 off does
    not either."""
    g = torch.Generator().manual_seed(3)
    S, L, shape = 4, 56, (8, 9, 10)
    x = (torch.randn((S, *shape, L), generator=g) * 3).to(torch.bfloat16)
    t = torch.nn.functional.one_hot(
        torch.randint(0, L, shape, generator=g), L).float()[None]
    w = torch.rand(L, generator=g) + 0.5
    w = w / w.sum()
    xg = x.detach().requires_grad_(True)
    want = segloss.seg_losses_plain(xg, t, w)
    (want_dx,) = torch.autograd.grad(want, xg)
    losses, dx = _passes(x, t, w.double(), 1.0, 1.0, broken)
    excess = segloss.grad_excess(dx.to(torch.bfloat16), want_dx)
    assert (excess <= 0) == (broken is None), excess
    want = torch.stack(want).detach()
    got = torch.stack(losses).float()
    assert segloss.loss_excess(got, want) <= 0
    assert segloss.loss_excess(got * (1 + 2e-5), want) > 0
