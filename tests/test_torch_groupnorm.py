"""brainfm_tpu_torch's GroupNorm forms, pair conv and upsample against the
JAX package's own functions (brainfm_tpu/models/unet3d.py) on the CPU:
`fused_group_norm` vs `_fused_groupnorm`, `pair_group_norm` vs
`_pair_groupnorm`, `phase_pair_conv` vs `_phase_pair_conv`,
`_nearest_upsample_to` vs its JAX twin, and a UNet3D with the pair path
against the JAX UNet3D's value_and_grad. Inputs are seeded numpy arrays;
JAX runs under x64. On the CPU the custom operators take their plain
versions (the kernels of csrc/groupnorm.cu are held to those on the card
by tests/test_torch_cuda.py).

Tolerances: fp64 values 1e-10 and gradients 1e-8, as
tests/test_phase_upconv.py (the two sum in other orders). bf16: the output
keeps the input's dtype; values within one bf16 ulp (both round the same
fp32 value, whose statistics differ in their last fp32 bits); input
gradients within 2 % relative L2 and the scale's and bias's within 1e-3
relative L2 (the combine rounds three times in bf16, as
tests/test_phase_upconv.py's TOLERANCE NOTE says, and XLA may fuse it).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brainfm_tpu.models import unet3d as u3
from brainfm_tpu_torch.models import from_jax_params
from brainfm_tpu_torch.models import unet3d as t3
from brainfm_tpu_torch.ops import groupnorm as gn

VAL_TOL = 1e-10
GRAD_TOL = 1e-8
BF16_GRAD_REL = 2e-2
BF16_PARAM_REL = 1e-3


@pytest.fixture(autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _to_jax(a):
    """(N, C, ...) numpy -> the JAX package's channels-last layout."""
    return jnp.asarray(np.moveaxis(a, 1, -1))


def _from_jax(a):
    return np.moveaxis(np.asarray(a, np.float64), -1, 1)


def _t(a, requires_grad=True):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(
        requires_grad)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=tol)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# (B, C, spatial): odd extents; C below, at and above the 8 groups
GN_CASES = [(1, 4, (5, 6, 7)), (2, 8, (3, 5, 4)), (2, 24, (5, 3, 3)),
            (1, 16, (7, 5)), (2, 64, (3, 3, 5))]


@pytest.mark.parametrize("B,C,spatial", GN_CASES)
def test_fused_group_norm_matches_jax(B, C, spatial):
    rng = np.random.default_rng(C + len(spatial))
    x = rng.standard_normal((B, C, *spatial)) * 2.0 + 0.5
    scale, bias = rng.standard_normal(C), rng.standard_normal(C)
    g = rng.standard_normal(x.shape)

    want, vjp = jax.vjp(lambda a, s, b: u3._fused_groupnorm(a, s, b, 8),
                        _to_jax(x), jnp.asarray(scale), jnp.asarray(bias))
    wx, ws, wb = vjp(_to_jax(g))

    tx, ts, tb = _t(x), _t(scale), _t(bias)
    got = gn.fused_group_norm(tx, ts, tb, 8)
    assert got.dtype == torch.float64
    _close(got.detach(), _from_jax(want), VAL_TOL)
    gx, gs, gb = torch.autograd.grad(got, (tx, ts, tb), torch.from_numpy(g))
    _close(gx, _from_jax(wx), GRAD_TOL)
    _close(gs, ws, GRAD_TOL)
    _close(gb, wb, GRAD_TOL)


def test_group_stats_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, 5, 4, 3)) + 3.0
    gmean, inv = u3._fgn_stats(_to_jax(x), 8, 1e-5)
    tm, ti = gn.group_stats(torch.from_numpy(x), 8)
    _close(tm, gmean, VAL_TOL)
    _close(ti, inv, VAL_TOL)


# (B, Ce, Cz, coarse extent): Ce + Cz below, at and above 8 groups
PAIR_CASES = [(1, 2, 4, (3, 4, 3)), (2, 4, 4, (2, 3, 3)),
              (2, 8, 16, (3, 2, 3)), (1, 16, 32, (2, 2, 3))]


def _pair_inputs(B, ce, cz, coarse, seed):
    rng = np.random.default_rng(seed)
    fine = tuple(2 * n for n in coarse)
    enc = rng.standard_normal((B, ce, *fine)) * 1.5 - 0.3
    z = rng.standard_normal((B, cz, *coarse)) + 0.7
    scale = rng.standard_normal(ce + cz)
    bias = rng.standard_normal(ce + cz)
    ge = rng.standard_normal(enc.shape)
    gz = rng.standard_normal(z.shape)
    return enc, z, scale, bias, ge, gz


@pytest.mark.parametrize("B,ce,cz,coarse", PAIR_CASES)
def test_pair_group_norm_matches_jax(B, ce, cz, coarse):
    enc, z, scale, bias, ge, gz = _pair_inputs(B, ce, cz, coarse, ce + cz)

    want, vjp = jax.vjp(
        lambda e, zz, s, b: u3._pair_groupnorm(e, zz, s, b, 8),
        _to_jax(enc), _to_jax(z), jnp.asarray(scale), jnp.asarray(bias))
    wd = vjp((_to_jax(ge), _to_jax(gz)))

    te, tz, ts, tb = _t(enc), _t(z), _t(scale), _t(bias)
    got = gn.pair_group_norm(te, tz, ts, tb, 8)
    _close(got[0].detach(), _from_jax(want[0]), VAL_TOL)
    _close(got[1].detach(), _from_jax(want[1]), VAL_TOL)
    gd = torch.autograd.grad(got, (te, tz, ts, tb),
                             (torch.from_numpy(ge), torch.from_numpy(gz)))
    _close(gd[0], _from_jax(wd[0]), GRAD_TOL)
    _close(gd[1], _from_jax(wd[1]), GRAD_TOL)
    _close(gd[2], wd[2], GRAD_TOL)
    _close(gd[3], wd[3], GRAD_TOL)


def test_pair_group_norm_is_the_group_norm_of_the_concat():
    """The pair's statistics are those of concat([enc, nearest_up2(z)]):
    the materialized form through fused_group_norm gives the same values
    and gradients."""
    enc, z, scale, bias, ge, gz = _pair_inputs(2, 8, 16, (3, 2, 3), 7)
    te, tz, ts, tb = _t(enc), _t(z), _t(scale), _t(bias)
    pe, pz = gn.pair_group_norm(te, tz, ts, tb, 8)
    up = t3._nearest_upsample_to(tz, te.shape[2:])
    full = gn.fused_group_norm(torch.cat([te, up], 1), ts, tb, 8)
    _close(pe.detach(), full[:, :8].detach(), VAL_TOL)
    _close(pz.detach(), full[:, 8:, ::2, ::2, ::2].detach(), VAL_TOL)
    gup = t3._nearest_upsample_to(torch.from_numpy(gz), te.shape[2:]) / 8
    a = torch.autograd.grad((pe, pz), (te, tz, ts, tb),
                            (torch.from_numpy(ge), torch.from_numpy(gz)))
    b = torch.autograd.grad(full, (te, tz, ts, tb),
                            torch.cat([torch.from_numpy(ge), gup], 1))
    for u, v in zip(a, b):
        _close(u, v, GRAD_TOL)


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("B,C,spatial", [(2, 16, (4, 5, 3)),
                                         (1, 8, (6, 4, 4))])
def test_bf16_keeps_its_dtype_and_matches_jax(B, C, spatial, pair):
    rng = np.random.default_rng(11)
    scale = rng.standard_normal(C).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    if pair:
        coarse = tuple(n // 2 for n in spatial)
        shapes = [(B, C // 2, *spatial), (B, C - C // 2, *coarse)]
    else:
        shapes = [(B, C, *spatial)]
    # the bf16 values both packages start from
    ins = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           .bfloat16() for s in shapes]
    gs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          .bfloat16() for s in shapes]

    def jx(t):
        return jnp.asarray(np.moveaxis(t.float().numpy(), 1, -1),
                           jnp.bfloat16)

    def jfn(*args):
        f = u3._pair_groupnorm if pair else u3._fused_groupnorm
        out = f(*args, 8)
        return out if pair else (out,)

    want, vjp = jax.vjp(jfn, *[jx(t) for t in ins], jnp.asarray(scale),
                        jnp.asarray(bias))
    wd = vjp(tuple(jx(g) for g in gs))

    targs = [t.clone().requires_grad_(True) for t in ins]
    ts, tb = _t(scale), _t(bias)
    got = (gn.pair_group_norm(*targs, ts, tb, 8) if pair
           else (gn.fused_group_norm(targs[0], ts, tb, 8),))
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        ga = a.detach().float().numpy()
        wb = _from_jax(b.astype(jnp.float32))
        ulp = 2.0 ** -7 * np.maximum(np.abs(ga), np.abs(wb))
        assert np.all(np.abs(ga - wb) <= ulp)
    gd = torch.autograd.grad(got, (*targs, ts, tb), tuple(gs))
    for a, b in zip(gd[:len(ins)], wd[:len(ins)]):
        assert a.dtype == torch.bfloat16
        assert _rel_l2(a.float().numpy(),
                       _from_jax(b.astype(jnp.float32))) < BF16_GRAD_REL
    for a, b in zip(gd[len(ins):], wd[len(ins):]):
        assert a.dtype == torch.float32
        assert _rel_l2(a.numpy(), b) < BF16_PARAM_REL


@pytest.mark.parametrize("ce,cz,co,coarse", [(4, 6, 3, (3, 4, 2)),
                                             (8, 16, 8, (2, 3, 3))])
def test_phase_pair_conv_matches_jax(ce, cz, co, coarse):
    rng = np.random.default_rng(ce * cz)
    fine = tuple(2 * n for n in coarse)
    enc = rng.standard_normal((2, ce, *fine))
    z = rng.standard_normal((2, cz, *coarse))
    w = rng.standard_normal((co, ce + cz, 3, 3, 3))
    g = rng.standard_normal((2, co, *fine))
    kj = jnp.asarray(np.transpose(w, (2, 3, 4, 1, 0)))

    want, vjp = jax.vjp(u3._phase_pair_conv, _to_jax(enc), _to_jax(z), kj)
    we, wz, wk = vjp(_to_jax(g))
    te, tz, tw = _t(enc), _t(z), _t(w)
    got = t3.phase_pair_conv(te, tz, tw)
    _close(got.detach(), _from_jax(want), VAL_TOL)
    ge, gz, gw = torch.autograd.grad(got, (te, tz, tw), torch.from_numpy(g))
    _close(ge, _from_jax(we), GRAD_TOL)
    _close(gz, _from_jax(wz), GRAD_TOL)
    _close(gw, np.transpose(np.asarray(wk), (4, 3, 0, 1, 2)), GRAD_TOL)
    # and the plain conv of the materialized concat
    up = t3._nearest_upsample_to(tz, te.shape[2:])
    plain = torch.nn.functional.conv3d(torch.cat([te, up], 1), tw,
                                       padding=1)
    _close(got.detach(), plain.detach(), VAL_TOL)


def test_phase_fold_is_the_jax_einsum():
    rng = np.random.default_rng(2)
    kb = rng.standard_normal((3, 5, 3, 3, 3))
    m = u3._PHASE_MAP.astype(np.float64)
    kj = np.einsum("xyzio,pxa,qyb,rzc->abcipqro",
                   np.transpose(kb, (2, 3, 4, 1, 0)), m, m, m)
    kj = kj.reshape(3, 3, 3, 5, 24)
    got = t3.fold_phase_kernel(torch.from_numpy(kb)).numpy()
    np.testing.assert_allclose(got, np.transpose(kj, (4, 3, 0, 1, 2)),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("src,tgt", [((4, 5, 3), (8, 10, 6)),
                                     ((4, 5, 3), (7, 9, 5)),
                                     ((4, 5, 3), (12, 15, 9)),
                                     ((4, 5, 3), (8, 9, 9)),
                                     ((4, 5, 3), (4, 10, 3))])
def test_nearest_upsample_matches_jax(src, tgt):
    """Ratios 2s, 2s - 1 and 3, mixed per axis, forward and gradient."""
    rng = np.random.default_rng(sum(tgt))
    x = rng.standard_normal((2, 3, *src))
    g = rng.standard_normal((2, 3, *tgt))
    want, vjp = jax.vjp(lambda a: u3._nearest_upsample_to(a, tgt),
                        _to_jax(x))
    tx = _t(x)
    got = t3._nearest_upsample_to(tx, tgt)
    assert tuple(got.shape) == (2, 3, *tgt)
    np.testing.assert_array_equal(got.detach().numpy(), _from_jax(want))
    (gx,) = torch.autograd.grad(got, tx, torch.from_numpy(g))
    _close(gx, _from_jax(vjp(_to_jax(g))[0]), 1e-12)


def _jax_unet(phase_upconv, x):
    model = u3.UNet3D(f_maps=8, num_levels=4, compute_dtype=jnp.float64,
                      phase_upconv=phase_upconv)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    return model, jax.tree.map(lambda a: np.asarray(a, np.float64), params)


def _port_unet(params, **kw):
    sd = from_jax_params({"params": {"backbone": params["params"]}})
    model = t3.UNet3D(f_maps=8, num_levels=4, **kw).double()
    model.load_state_dict({k.removeprefix("backbone."): torch.from_numpy(
        np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
        for k, v in sd.items()}, strict=True)
    return model


def _value_and_grad_jax(model, params, x, w):
    def loss(p):
        return jnp.sum(model.apply(p, jnp.asarray(x)) * jnp.asarray(w))
    return jax.value_and_grad(loss)(params)


def _value_and_grad_port(model, x, w):
    model.zero_grad()
    loss = (model(torch.from_numpy(_from_jax(x))) * torch.from_numpy(
        _from_jax(w))).sum()
    loss.backward()
    return float(loss.detach()), {k: p.grad.clone() for k, p in
                         model.named_parameters()}


def _assert_grads(grads, jgrads):
    want = from_jax_params({"params": {"backbone": jgrads["params"]}})
    assert len(want) == len(grads)
    for k, v in want.items():
        _close(grads[k.removeprefix("backbone.")], np.asarray(v), GRAD_TOL)


def _count_pairs(monkeypatch):
    hits = []
    real = t3.phase_pair_conv

    def counting(enc, z, weight):
        hits.append(tuple(z.shape[2:]))
        return real(enc, z, weight)

    monkeypatch.setattr(t3, "phase_pair_conv", counting)
    return hits


@pytest.mark.parametrize("size", [32, 33])
def test_unet3d_pair_path_matches_jax_value_and_grad(size, monkeypatch):
    """L4, f_maps 8: at 32^3 every decoder level takes the pair; at 33^3
    the last (16 -> 33) does not, as in the JAX gate."""
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, size, 1))
    w = rng.standard_normal((2, size, size, size, 8))
    jm, params = _jax_unet(True, x)
    jl, jg = _value_and_grad_jax(jm, params, x, w)
    hits = _count_pairs(monkeypatch)
    tl, tg = _value_and_grad_port(_port_unet(params), x, w)
    assert hits == ([(4,) * 3, (8,) * 3, (16,) * 3] if size == 32
                    else [(4,) * 3, (8,) * 3])
    assert abs(tl - float(jl)) <= VAL_TOL * max(1.0, abs(float(jl)))
    _assert_grads(tg, jg)


def test_phase_upconv_false_is_the_plain_path_in_both(monkeypatch):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 16, 16, 16, 1))
    w = rng.standard_normal((1, 16, 16, 16, 8))
    jm, params = _jax_unet(False, x)
    jl, jg = _value_and_grad_jax(jm, params, x, w)
    jhits = []
    real = u3._phase_pair_conv
    monkeypatch.setattr(u3, "_phase_pair_conv",
                        lambda *a: jhits.append(1) or real(*a))
    jm.apply(params, jnp.asarray(x))
    hits = _count_pairs(monkeypatch)
    tl, tg = _value_and_grad_port(_port_unet(params, phase_upconv=False),
                                  x, w)
    assert hits == [] and jhits == []
    assert abs(tl - float(jl)) <= VAL_TOL * max(1.0, abs(float(jl)))
    _assert_grads(tg, jg)
    # the cfg flag reaches the backbone as the JAX build_backbone reads it
    from brainfm_tpu_torch.config import AttrDict
    from brainfm_tpu_torch.models.build import build_backbone
    for flag in (True, False):
        net = build_backbone(AttrDict.from_nested({
            "backbone": "unet3d", "f_maps": 8, "num_levels": 3,
            "phase_upconv": flag}))
        assert all(d.phase_upconv is flag for d in net.decoders)


@pytest.mark.parametrize("remat", ["full", "save_convs"])
def test_remat_gives_the_remat_off_gradients(remat):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 16, 16, 16, 1))
    w = rng.standard_normal((2, 16, 16, 16, 8))
    _, params = _jax_unet(True, x)
    l0, g0 = _value_and_grad_port(_port_unet(params), x, w)
    l1, g1 = _value_and_grad_port(_port_unet(params, remat=remat), x, w)
    assert abs(l1 - l0) <= VAL_TOL * max(1.0, abs(l0))
    for k in g0:
        _close(g1[k], g0[k], GRAD_TOL)


def test_save_convs_keeps_one_convolution_output_per_single_conv():
    """Under `save_convs` the pair's two convolutions are one operator
    with one output, the tensor the policy keeps (JAX's one `conv_out`)."""
    from torch.utils.checkpoint import CheckpointPolicy

    policy = t3._save_convs_policy
    assert policy(None, torch.ops.brainfm.phase_pair_conv.default) \
        == CheckpointPolicy.MUST_SAVE
    assert policy(None, torch.ops.aten.convolution.default) \
        == CheckpointPolicy.MUST_SAVE
    for op in (torch.ops.brainfm.chan_sums.default,
               torch.ops.brainfm.chan_affine.default,
               torch.ops.brainfm.chan_affine3.default):
        assert policy(None, op) == CheckpointPolicy.PREFER_RECOMPUTE


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    """On the CPU each operator takes its plain version; a meta tensor
    goes to the fake implementations (shapes only)."""
    x = torch.randn(2, 8, 3, 4, 5)
    s = gn.chan_sums(x)
    assert s.shape == (2, 2, 8) and s.dtype == torch.float32
    _close(s, gn.chan_sums_plain(x), 0)
    m = gn.chan_sums(x.to("meta"))
    assert m.device.type == "meta" and m.shape == (2, 2, 8)
    a = torch.randn(2, 8)
    y = gn.chan_affine(x.bfloat16(), a, a)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, gn.chan_affine_plain(x.bfloat16(), a, a))
    with pytest.raises(ValueError):
        gn._sums_cuda(x, None)


# ---- the channels-last (NDHWC) form against the NCDHW one ----
# The same functions on the same values held NDHWC (`channels_last_3d`,
# the card's layout; the CPU takes the plain versions, which keep it):
# the values and gradients of the NCDHW inputs, and the outputs NDHWC.
# fp64 where nothing convolves (the two sum in other orders: VAL_TOL and
# GRAD_TOL); float32 where a convolution runs, since the CPU's fp64
# convolution returns NCDHW whatever its input (the values within 1e-5 of
# their largest magnitude and the gradients within 1e-5 relative L2:
# oneDNN's NDHWC and NCDHW algorithms sum in other orders).
CL_VAL_REL = 1e-5
CL_GRAD_REL = 1e-5


def _last(t):
    """t's values with channels innermost (N, ..., C) in memory."""
    return t.detach().movedim(1, -1).contiguous().movedim(-1, 1)


def _is_last(t):
    """Channels innermost in memory: dense NDHWC, or a channel slice of
    one (a head's output)."""
    p = t.movedim(1, -1)
    return p.stride(-1) == 1 and all(
        p.stride(i) >= p.stride(i + 1) * p.shape[i + 1]
        for i in range(p.dim() - 1))


def _gn_case(B, C, spatial, dt=torch.float64, seed=0):
    rng = np.random.default_rng(seed + C)
    x = torch.from_numpy(rng.standard_normal((B, C, *spatial)) * 2 + 0.5)
    return (x.to(dt), torch.from_numpy(rng.standard_normal(C)).to(dt),
            torch.from_numpy(rng.standard_normal(C)).to(dt),
            torch.from_numpy(rng.standard_normal(x.shape)).to(dt))


def _cl_plain(kind, B, C, spatial):
    x, _, _, g = _gn_case(B, C, spatial)
    a, b = (torch.from_numpy(np.random.default_rng(s).standard_normal(
        (B, C))) for s in (1, 2))
    fn = {"chan_sums_plain": lambda t, u: gn.chan_sums_plain(u, t),
          "chan_affine_plain": lambda t, u: gn.chan_affine_plain(t, a, b),
          "chan_affine3_plain": lambda t, u: gn.chan_affine3_plain(
              u, t, a, b, a * b)}[kind]
    return fn, [x, g], [], lambda out: out if kind != "chan_sums_plain" \
        else None


def _cl_fused(B, C, spatial):
    x, s, b, _ = _gn_case(B, C, spatial)
    return (lambda t, s, b: gn.fused_group_norm(t, s, b, 8)), [x], [s, b], \
        lambda out: out


def _cl_pair(B, ce, cz, coarse):
    enc, z, scale, bias, _, _ = _pair_inputs(B, ce, cz, coarse, ce + cz)
    t = [torch.from_numpy(a) for a in (enc, z, scale, bias)]
    return (lambda e, zz, s, b: gn.pair_group_norm(e, zz, s, b, 8)), \
        t[:2], t[2:], lambda out: out


def _cl_phase_conv(ce, cz, co, coarse):
    rng = np.random.default_rng(ce * cz)
    fine = tuple(2 * n for n in coarse)
    enc, z = (torch.from_numpy(rng.standard_normal((2, c, *s))).float()
              for c, s in ((ce, fine), (cz, coarse)))
    w = torch.from_numpy(rng.standard_normal((co, ce + cz, 3, 3, 3))).float()
    return t3.phase_pair_conv, [enc, z], [w], lambda out: out


def _cl_upsample(src, tgt):
    x = torch.from_numpy(np.random.default_rng(sum(tgt)).standard_normal(
        (2, 3, *src)))
    return (lambda t: t3._nearest_upsample_to(t, tgt)), [x], [], \
        lambda out: out


def _cl_head():
    from brainfm_tpu_torch.models.heads import TaskHead

    torch.manual_seed(3)
    head = TaskHead(8, (8, 8), {"T1": 1, "seg": 5, "age": -1},
                    size=(16, 16, 16))
    x = torch.randn(2, 8, 16, 16, 16)
    return (lambda t, *p: tuple(head([t]).values())), [x], \
        list(head.parameters()), lambda out: out[:2]


def _cl_unet(size):
    torch.manual_seed(size)
    net = t3.UNet3D(in_channels=3, f_maps=8, num_levels=3)
    x = torch.randn(2, 3, size, size, size)
    return (lambda t, *p: tuple(net.get_feature(t))), [x], \
        list(net.parameters()), lambda out: out


CL_CASES = {
    **{f"{k} {c}": (lambda k=k, c=c: _cl_plain(k, *c))
       for k in ("chan_sums_plain", "chan_affine_plain",
                 "chan_affine3_plain") for c in GN_CASES},
    **{f"fused_group_norm {c}": (lambda c=c: _cl_fused(*c))
       for c in GN_CASES},
    **{f"pair_group_norm {c}": (lambda c=c: _cl_pair(*c))
       for c in PAIR_CASES},
    "phase_pair_conv": lambda: _cl_phase_conv(8, 16, 8, (2, 3, 3)),
    **{f"nearest_upsample {tgt}": (lambda tgt=tgt: _cl_upsample(
        (4, 5, 3), tgt)) for tgt in ((8, 10, 6), (7, 9, 5), (12, 15, 9))},
    "task_head": _cl_head,
    # every decoder level on the pair at 16^3; at 18^3 one upsamples
    # (9 -> 18 is a pair, 4 -> 9 gathers) and concatenates
    "unet3d 16": lambda: _cl_unet(16),
    "unet3d 18": lambda: _cl_unet(18),
}


def _rel_l2_t(got, want):
    return float((got - want).double().norm()
                 / want.double().norm().clamp(min=1e-300))


@pytest.mark.parametrize("case", list(CL_CASES))
def test_channels_last_gives_the_ncdhw_values_and_gradients(case):
    fn, acts, params, laid_out = CL_CASES[case]()
    fp32 = acts[0].dtype == torch.float32
    res = []
    for layout in (lambda t: t.detach().clone(), _last):
        ins = [layout(t).requires_grad_(True) for t in acts]
        ps = [p.detach().clone().requires_grad_(True) for p in params]
        out = fn(*ins, *ps)
        out = out if isinstance(out, tuple) else (out,)
        rng = np.random.default_rng(1)
        # the incoming gradients in their outputs' layouts
        ws = [torch.empty_like(o).copy_(torch.from_numpy(
            rng.standard_normal(o.shape))) for o in out]
        grads = torch.autograd.grad(out, ins + ps, ws, allow_unused=True)
        res.append((out, grads, ins))
    (oa, ga, _), (ob, gb, ib) = res
    for a, b in zip(oa, ob):
        if fp32:
            assert float((a - b).abs().max()) <= CL_VAL_REL * float(
                a.abs().max()), case
        else:
            _close(b.detach(), a.detach(), VAL_TOL)
    for a, b in zip(ga, gb):
        if a is None:
            assert b is None
        elif fp32:
            assert _rel_l2_t(b, a) <= CL_GRAD_REL, case
        else:
            _close(b, a, GRAD_TOL)
    checked = laid_out(ob)
    if checked is not None:
        for o in checked:
            assert o.dim() < 3 or _is_last(o), (case, o.stride())
    for g in gb[:len(ib)]:
        assert g is None or _is_last(g), (case, g.stride())


@pytest.mark.parametrize("where", ["card", "cpu", "space scope", "2-d"])
def test_model_input_keeps_the_cards_channels_last_strides(where):
    """The joiners' (N, D, H, W, C) input: on the card (a meta tensor takes
    that branch), in a space scope too, the permute's NDHWC strides, no
    copy; on the CPU and for the 2-D UNet plain NCDHW / NCHW strides."""
    from brainfm_tpu_torch.models.build import _model_input
    from brainfm_tpu_torch.parallel.spatial import use_scope

    dev = "cpu" if where == "cpu" else "meta"
    x = torch.empty((2, 20, 18, 16, 2) if where != "2-d" else (2, 18, 16, 2),
                    device=dev)
    with use_scope(object() if where == "space scope" else None):
        got = _model_input(x)
    assert got.shape == x.movedim(-1, 1).shape
    if where in ("card", "space scope"):
        assert got.stride() == x.movedim(-1, 1).stride()
        assert t3.channels_last(got)
    else:
        assert got.is_contiguous()
