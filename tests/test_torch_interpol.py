"""The port's interpol family against the JAX package on the CPU: boundary
folding, spline bases, grid_pull / push / count / grad / hess over orders,
bounds, dimensions and extrapolation, the pull-push adjoint, autograd
through grid_pull, the identity and affine grids, the recursive prefilter
(also against scipy) and the spline resize and restriction. fp64 on both
sides (JAX under x64), inputs from numpy seeds."""

import contextlib
import itertools

import numpy as np
import pytest
import torch
from scipy.ndimage import spline_filter1d

import jax
import jax.numpy as jnp

from brainfm_tpu.ops import bounds as jbounds
from brainfm_tpu.ops import coeff as jcoeff
from brainfm_tpu.ops import pushpull as jpp
from brainfm_tpu.ops import resize as jresize
from brainfm_tpu.ops import splines as jsplines
from brainfm_tpu_torch.ops import bounds, coeff, pushpull, resize, splines

# fp64 on both sides: the same operations, summed in the same corner order
# (push: scatter-adds in another order)
F64_RTOL = 1e-10
# grid_count splats fp32 ones in both packages: fp32 sums in another order
F32_RTOL = 1e-6
BOUNDS = ("zero", "replicate", "dct1", "dct2", "dst1", "dst2", "dft")
ALIASES = {"zeros": "zero", "nearest": "replicate", "mirror": "dct1",
           "reflect": "dct2", "antimirror": "dst1", "antireflect": "dst2",
           "wrap": "dft"}
SHAPES = {1: (6,), 2: (5, 6), 3: (4, 5, 6)}


@contextlib.contextmanager
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def close(got, want, rtol=F64_RTOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def case(seed, dim, channels=2, n_out=(3, 4, 2)):
    """A (*shape, C) fp64 image and a (*out, dim) grid reaching two voxels
    outside the image on every side."""
    rng = np.random.default_rng(seed)
    shape = SHAPES[dim]
    img = rng.standard_normal(shape + (channels,))
    out = n_out[:dim]
    grid = np.stack([rng.uniform(-2.5, n + 1.5, out) for n in shape], -1)
    return img, grid


@pytest.mark.parametrize("bound", BOUNDS)
def test_apply_bound_matches_jax(bound):
    i = np.arange(-20, 21)
    for n in (1, 2, 5):
        for name in [bound] + [a for a, b in ALIASES.items() if b == bound]:
            idx, sign = bounds.apply_bound(torch.from_numpy(i), n, name)
            jidx, jsign = jbounds.apply_bound(jnp.asarray(i), n, name)
            np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
            np.testing.assert_array_equal(sign.numpy(), np.asarray(jsign))
            assert bounds.bound_code(name) == jbounds.bound_code(name)


@pytest.mark.parametrize("order", range(8))
def test_spline_basis_matches_jax(order):
    x = np.linspace(-5.0, 5.0, 2001)
    t = torch.from_numpy(x)
    with x64():
        jx = jnp.asarray(x)
        for fn in ("spline_weight", "spline_grad", "spline_hess"):
            if fn == "spline_hess" and order > 3:
                with pytest.raises(NotImplementedError):
                    splines.spline_hess(t, order)
                continue
            close(getattr(splines, fn)(t, order),
                  getattr(jsplines, fn)(jx, order), 1e-12)


def _both(fn, img, grid, *args, **kw):
    with x64():
        want = getattr(jpp, fn)(jnp.asarray(img), jnp.asarray(grid), *args,
                                **kw)
    got = getattr(pushpull, fn)(torch.from_numpy(img),
                                torch.from_numpy(grid), *args, **kw)
    return got, want


def _both_extrapolations(fn, img, grid, **kw):
    """`fn` with extrapolate True and False against the JAX package: the
    masked expectation is JAX's unmasked result under JAX's own in-bounds
    mask (one JAX evaluation for both)."""
    got, want = _both(fn, img, grid, extrapolate=True, **kw)
    close(got, want)
    shape = img.shape[:grid.shape[-1]]
    with x64():
        ok = np.asarray(jpp._inbounds_mask(jnp.asarray(grid), shape, False))
    want = np.asarray(want)
    ok = ok.reshape(ok.shape + (1,) * (want.ndim - ok.ndim))
    close(getattr(pushpull, fn)(torch.from_numpy(img), torch.from_numpy(grid),
                                extrapolate=False, **kw),
          np.where(ok, want, 0.0))


@pytest.mark.parametrize("order", [0, 1, 2, 3, 5, 7])
def test_grid_pull_matches_jax(order):
    for (dim, bound), seed in zip(itertools.product((1, 2, 3), BOUNDS),
                                  itertools.count()):
        img, grid = case(seed, dim)
        kw = dict(interpolation=order, bound=bound)
        _both_extrapolations("grid_pull", img, grid, **kw)
        if dim == 3 and bound == "dct2":   # channel-less input
            close(*_both("grid_pull", img[..., 0], grid, **kw))
    # JAX's own masked path, once
    img, grid = case(99, 3)
    close(*_both("grid_pull", img, grid, interpolation=order,
                 extrapolate=False))


@pytest.mark.parametrize("fn", ["grid_push", "grid_count", "grid_grad",
                                "grid_hess"])
@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_push_count_grad_hess_match_jax(fn, order):
    for (dim, bound), seed in zip(itertools.product((1, 2, 3), BOUNDS),
                                  itertools.count(100)):
        img, grid = case(seed, dim)
        kw = dict(interpolation=order, bound=bound)
        shape = SHAPES[dim]
        for extrap in (True, False):
            if fn == "grid_push":
                vals = np.random.default_rng(seed).standard_normal(
                    grid.shape[:-1] + (2,))
                close(*_both(fn, vals, grid, shape, extrapolate=extrap,
                             **kw))
            elif fn == "grid_count":
                with x64():
                    want = jpp.grid_count(jnp.asarray(grid), shape,
                                          extrapolate=extrap, **kw)
                close(pushpull.grid_count(torch.from_numpy(grid), shape,
                                          extrapolate=extrap, **kw),
                      want, F32_RTOL)
        if fn in ("grid_grad", "grid_hess"):
            _both_extrapolations(fn, img, grid, **kw)
    if fn in ("grid_grad", "grid_hess"):
        img, grid = case(98, 2)
        close(*_both(fn, img, grid, interpolation=order, extrapolate=False))
        close(*_both(fn, img[..., 0], grid, interpolation=order))


def test_per_dimension_orders_and_bounds():
    img, grid = case(7, 3)
    kw = dict(interpolation=[1, 3, 0], bound=["dct2", "zero", "dft"])
    for fn in ("grid_pull", "grid_grad", "grid_hess"):
        close(*_both(fn, img, grid, **kw))
    vals = np.random.default_rng(8).standard_normal(grid.shape[:-1] + (2,))
    close(*_both("grid_push", vals, grid, SHAPES[3], **kw))


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_pull_push_adjoint(order):
    """<pull(x), y> = <x, push(y)> at fp64, with and without
    extrapolation."""
    for bound, extrap in itertools.product(("zero", "dct2", "dst1", "dft"),
                                           (True, False)):
        img, grid = case(order, 3)
        x = torch.from_numpy(img)
        g = torch.from_numpy(grid)
        y = torch.from_numpy(np.random.default_rng(order + 50)
                             .standard_normal(grid.shape[:-1] + (2,)))
        kw = dict(interpolation=order, bound=bound, extrapolate=extrap)
        lhs = float((pushpull.grid_pull(x, g, **kw) * y).sum())
        rhs = float((x * pushpull.grid_push(y, g, SHAPES[3], **kw)).sum())
        assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)


@pytest.mark.parametrize("order,bound", [(1, "zero"), (3, "dct2"),
                                         (2, "dft")])
def test_grid_pull_autograd_matches_jax_grad(order, bound):
    img, grid = case(11, 3)
    w = np.random.default_rng(12).standard_normal(grid.shape[:-1] + (2,))
    kw = dict(interpolation=order, bound=bound)
    with x64():
        def loss(i, g):
            return jnp.sum(jpp.grid_pull(i, g, **kw) * w)
        ji, jg = jax.grad(loss, argnums=(0, 1))(jnp.asarray(img),
                                                jnp.asarray(grid))
    x = torch.from_numpy(img).requires_grad_()
    g = torch.from_numpy(grid).requires_grad_()
    (pushpull.grid_pull(x, g, **kw) * torch.from_numpy(w)).sum().backward()
    close(x.grad, ji)
    close(g.grad, jg)


def test_identity_and_affine_grids_match_jax():
    rng = np.random.default_rng(3)
    with x64():
        close(pushpull.identity_grid((3, 4, 5), torch.float64),
              jpp.identity_grid((3, 4, 5), jnp.float64))
        disp = rng.standard_normal((3, 4, 2))
        close(pushpull.add_identity_grid(torch.from_numpy(disp)),
              jpp.add_identity_grid(jnp.asarray(disp)))
        for rows in (3, 4):
            mat = rng.standard_normal((2, rows, 4))
            close(pushpull.affine_grid(torch.from_numpy(mat), (3, 4, 5)),
                  jpp.affine_grid(jnp.asarray(mat), (3, 4, 5)))
    with pytest.raises(ValueError):
        pushpull.affine_grid(torch.eye(4, dtype=torch.float64), (3, 4))


@pytest.mark.parametrize("order", [2, 3, 4, 5, 6, 7])
def test_spline_coeff_matches_jax_and_scipy(order):
    rng = np.random.default_rng(order)
    for bound, scipy_mode in (("dct1", "mirror"), ("dct2", "reflect"),
                              ("dft", "grid-wrap"), ("zero", None),
                              ("replicate", None)):
        for n in (31, 3):
            x = rng.standard_normal((n, 4))
            got = coeff.spline_coeff(torch.from_numpy(x), bound, order,
                                     axis=0)
            with x64():
                close(got, jcoeff.spline_coeff(jnp.asarray(x), bound, order,
                                               axis=0))
            if scipy_mode and n == 31 and order <= 5:
                np.testing.assert_allclose(
                    got.numpy(), spline_filter1d(x, order=order,
                                                 mode=scipy_mode, axis=0),
                    rtol=1e-5, atol=1e-6)
    one = torch.from_numpy(rng.standard_normal((1, 3)))
    assert torch.equal(coeff.spline_coeff(one, "dct2", order, axis=0), one)
    if order == 3:
        x = rng.standard_normal((9, 10, 11))
        got = coeff.spline_coeff_nd(torch.from_numpy(x), "dct2", order)
        with x64():
            close(got, jcoeff.spline_coeff_nd(jnp.asarray(x), "dct2", order))
    assert coeff.get_gain(coeff.get_poles(order)) == \
        jcoeff.get_gain(jcoeff.get_poles(order))


# the JAX package compiles each operation once per shape, so every anchor
# and switch runs on the same few shapes
@pytest.mark.parametrize("order", [1, 3])
def test_resize_spline_matches_jax(order):
    rng = np.random.default_rng(order)
    img = rng.standard_normal((7, 6, 5))
    imgc = rng.standard_normal((7, 6, 5, 2))
    for (i, anchor), (x, sz) in itertools.product(
            enumerate("cefl"), ((img, dict(shape=(11, 4, 9))),
                                (imgc, dict(factor=[1.5, 0.75, 2.0])))):
        prefilter, extrap = i % 2 == 0, i < 2
        kw = dict(anchor=anchor, interpolation=order, bound="dct2",
                  prefilter=prefilter, extrapolate=extrap)
        with x64():
            want = jresize.resize_spline(jnp.asarray(x), **sz, **kw)
        close(resize.resize_spline(torch.from_numpy(x), **sz, **kw), want)
    with x64():
        want = jresize.resize_spline(jnp.asarray(img), factor=1.7,
                                     interpolation=order)
    close(resize.resize_spline(torch.from_numpy(img), factor=1.7,
                               interpolation=order), want)


@pytest.mark.parametrize("order", [1, 3])
def test_restrict_spline_matches_jax_and_is_the_adjoint(order):
    rng = np.random.default_rng(10 + order)
    fine = rng.standard_normal((10, 9, 8))
    finec = rng.standard_normal((10, 9, 8, 2))
    for anchor, norm, (x, sz) in itertools.chain(
            itertools.product("cefl", ("reduce_sum", "fullscale", "count"),
                              [(fine, dict(shape=(5, 4, 6)))]),
            itertools.product("c", ("reduce_sum", "fullscale", "count"),
                              [(finec, dict(factor=0.5))])):
        kw = dict(anchor=anchor, interpolation=order, bound="dct2",
                  reduce_sum=norm == "reduce_sum",
                  normalize="fullscale" if norm == "reduce_sum" else norm)
        with x64():
            want = jresize.restrict_spline(jnp.asarray(x), **sz, **kw)
        close(resize.restrict_spline(torch.from_numpy(x), **sz, **kw), want)
    # the pure restriction is the transpose of the resize (no prefilter)
    for anchor in "cefl":
        c = torch.from_numpy(rng.standard_normal((5, 4, 6)))
        f = torch.from_numpy(fine)
        up = resize.resize_spline(c, shape=(10, 9, 8), anchor=anchor,
                                  interpolation=order, bound="dct2",
                                  prefilter=False)
        down = resize.restrict_spline(f, shape=(5, 4, 6), anchor=anchor,
                                      interpolation=order, bound="dct2",
                                      reduce_sum=True)
        lhs, rhs = float((up * f).sum()), float((c * down).sum())
        assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)
