"""The rest of the port's numerics against the JAX package on the CPU:
synth_intensities (the K2 lookup's plain version here), odeint_adjoint's
values for every method and its fp64 gradients, the refusal of a gradient
through the adaptive solver, interp3d, the training meters, and every name
of the JAX package's exports. Inputs from numpy seeds."""

import contextlib
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brainfm_tpu.ops import interp as jinterp
from brainfm_tpu.ops import ode as jode
from brainfm_tpu.synth import constants as jconst
from brainfm_tpu.synth import gmm as jgmm
from brainfm_tpu.utils import logging as jlog
from brainfm_tpu_torch.ops import interp as tinterp
from brainfm_tpu_torch.ops import ode as tode
from brainfm_tpu_torch.synth import constants as tconst
from brainfm_tpu_torch.synth import gmm as tgmm
from brainfm_tpu_torch.synth.draws import Draws
from brainfm_tpu_torch.utils import logging as tlog

METHODS = ("euler", "midpoint", "rk4", "dopri5", "tsit5", "adams",
           "explicit_adams", "fixed_adams")
# fp64 on both sides: the same steps; only the state's arithmetic order
F64_RTOL = 1e-10
# fp32 on both sides (the adaptive pairs take the same steps, rounding in
# the stage sums differs in its last bits)
F32_RTOL = 1e-5


@contextlib.contextmanager
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _labels(seed, shape=(12, 10, 14)):
    rng = np.random.default_rng(seed)
    lab = rng.choice(np.array([0, 2, 3, 4, 41, 77, 120, 251, 255, 300]),
                     shape).astype(np.int32)
    return lab


@pytest.mark.parametrize("hemis", [False, True])
def test_synth_intensities_matches_jax_exactly(hemis):
    """Injected noise: the 77 -> 2 merge, the hemisphere zeroing, the clip
    to [0, 255], the (256, 2) lookup, the draw and the clamp, bitwise."""
    rng = np.random.default_rng(3)
    lab = _labels(1)
    mus = (25 + 200 * rng.random(256)).astype(np.float32)
    sig = (5 + 20 * rng.random(256)).astype(np.float32)
    noise = rng.standard_normal(lab.shape).astype(np.float32) * 8
    hm = (rng.random(lab.shape) > 0.5).astype(np.int32) if hemis else None
    want = np.asarray(jgmm.synth_intensities(
        jax.random.PRNGKey(0), jnp.asarray(lab), jnp.asarray(mus),
        jnp.asarray(sig), None if hm is None else jnp.asarray(hm),
        noise=jnp.asarray(noise)))
    got = tgmm.synth_intensities(
        Draws(), torch.from_numpy(lab), torch.from_numpy(mus),
        torch.from_numpy(sig), None if hm is None else torch.from_numpy(hm),
        noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got == 0).any() and got.min() >= 0


def test_synth_intensities_draws_and_replays_its_noise():
    lab = torch.from_numpy(_labels(2))
    mus, sig = torch.rand(256) * 200, torch.rand(256) * 20
    rec = {}
    a = tgmm.synth_intensities(Draws(torch.Generator().manual_seed(0),
                                     record=rec), lab, mus, sig)
    assert tuple(rec["noise"].shape) == tuple(lab.shape)
    b = tgmm.synth_intensities(Draws(given=rec), lab, mus, sig)
    assert torch.equal(a, b)


def _rhs(k=0.7):
    def jf(t, y):
        return -k * y + jnp.sin(3.0 * t) * y ** 2

    def tf(t, y):
        return -k * y + float(np.sin(3.0 * t)) * y ** 2
    return jf, tf


@pytest.mark.parametrize("method", METHODS)
def test_odeint_adjoint_values_match_jax_and_odeint(method):
    jf, tf = _rhs()
    y0 = np.array([1.0, 0.5, 0.25, -0.4])
    ts = np.arange(6) * 0.3
    with x64():
        want = np.asarray(jode.odeint_adjoint(jf, jnp.asarray(y0),
                                              jnp.asarray(ts), dt=0.1,
                                              method=method))
    got = tode.odeint_adjoint(tf, torch.from_numpy(y0), ts, dt=0.1,
                              method=method)
    np.testing.assert_allclose(got.numpy(), want, rtol=F64_RTOL,
                               atol=F64_RTOL)
    if method != "adams":  # odeint takes dopri5 for 'adams'
        ref = tode.odeint(tf, torch.from_numpy(y0), ts, dt=0.1,
                          method=method)
        assert torch.equal(got, ref)
    # fp32: the adaptive pairs take JAX's steps
    want32 = np.asarray(jode.odeint_adjoint(
        jf, jnp.asarray(y0, jnp.float32), jnp.asarray(ts, jnp.float32),
        dt=0.1, method=method))
    got32 = tode.odeint_adjoint(tf, torch.from_numpy(y0).float(), ts, dt=0.1,
                                method=method)
    np.testing.assert_allclose(got32.numpy(), want32, rtol=F32_RTOL,
                               atol=F32_RTOL)


@pytest.mark.parametrize("method", ["euler", "midpoint", "rk4"])
def test_odeint_adjoint_fp64_gradients_match_jax(method):
    """Gradients in y0 and in a parameter of the right-hand side, through
    the checkpointed intervals, against jax.grad (as
    tests/test_coeff_fd_ode.py:143-182 holds the JAX package to its own
    odeint)."""
    y0 = np.array([1.0, 2.0, -0.5])
    ts = np.linspace(0.0, 1.0, 6)
    w = np.array([0.3, -1.2, 0.8])

    with x64():
        def loss(y, k):
            f = (lambda t, yy: -k * yy + jnp.sin(t))
            out = jode.odeint_adjoint(f, y, jnp.asarray(ts), method=method)
            return jnp.sum(out[-1] ** 2 * w) + jnp.sum(out[2])
        jy, jk = jax.grad(loss, argnums=(0, 1))(jnp.asarray(y0),
                                                jnp.float64(0.7))
    y = torch.from_numpy(y0).requires_grad_()
    k = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    out = tode.odeint_adjoint(lambda t, yy: -k * yy + float(np.sin(t)), y,
                              ts, method=method)
    (torch.sum(out[-1] ** 2 * torch.from_numpy(w))
     + torch.sum(out[2])).backward()
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(jy),
                               rtol=F64_RTOL)
    np.testing.assert_allclose(float(k.grad), float(jk), rtol=F64_RTOL)


@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
def test_odeint_adjoint_refuses_adaptive_gradients(method):
    _, tf = _rhs()
    ts = np.arange(4) * 0.3
    y = torch.ones(3, dtype=torch.float64, requires_grad=True)
    with pytest.raises(RuntimeError, match="fixed-step"):
        tode.odeint_adjoint(tf, y, ts, method=method)
    k = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    with pytest.raises(RuntimeError, match="fixed-step"):
        tode.odeint_adjoint(lambda t, yy: -k * yy, torch.ones(3).double(),
                            ts, method=method)
    with torch.no_grad():
        tode.odeint_adjoint(tf, y, ts, method=method)


@pytest.mark.parametrize("mode", ["linear", "nearest"])
def test_interp3d_matches_jax(mode):
    rng = np.random.default_rng(4)
    vol = rng.standard_normal((9, 8, 10, 2)).astype(np.float32)
    ii, jj, kk = (rng.uniform(-1.5, n + 0.5, (5, 6, 4)).astype(np.float32)
                  for n in (9, 8, 10))
    want = np.asarray(jinterp.interp3d(jnp.asarray(vol), jnp.asarray(ii),
                                       jnp.asarray(jj), jnp.asarray(kk),
                                       mode=mode, default=0.25))
    got = tinterp.interp3d(torch.from_numpy(vol), torch.from_numpy(ii),
                           torch.from_numpy(jj), torch.from_numpy(kk),
                           mode=mode, default=0.25)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tinterp.interp3d(torch.from_numpy(vol), *[torch.zeros(1)] * 3,
                         mode="cubic")


def test_meters_and_constants_match_jax():
    vals = [3.0, 1.5, 4.25, 0.5, 2.0, 7.0]
    for window in (3, 20):
        a, b = tlog.SmoothedValue(window), jlog.SmoothedValue(window)
        for i, v in enumerate(vals):
            a.update(v, n=i + 1)
            b.update(v, n=i + 1)
        for attr in ("median", "avg", "global_avg", "max", "value"):
            assert getattr(a, attr) == getattr(b, attr), attr
        assert str(a) == str(b)
        a.synchronize_between_processes()   # no process group: unchanged
        assert a.count == b.count and a.total == b.total
    ml, jl = tlog.MetricLogger(), jlog.MetricLogger()
    for v in vals:
        ml.update(loss=v, lr=v / 10)
        jl.update(loss=v, lr=v / 10)
    assert str(ml) == str(jl)
    assert ml.loss.global_avg == jl.loss.global_avg
    with pytest.raises(AttributeError):
        ml.missing
    assert tconst.RIGHT_TO_LEFT == jconst.RIGHT_TO_LEFT


@pytest.mark.parametrize("pkg", ["ops", "synth", "models", "infer", "train",
                                 "utils"])
def test_every_exported_name_resolves_in_the_port(pkg):
    jmod = importlib.import_module(f"brainfm_tpu.{pkg}")
    tmod = importlib.import_module(f"brainfm_tpu_torch.{pkg}")
    missing = [n for n in jmod.__all__ if not hasattr(tmod, n)]
    assert not missing, missing
    assert set(tmod.__all__) >= set(jmod.__all__)
