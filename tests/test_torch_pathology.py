"""The port's pathology generator against the JAX package on the CPU:
ops/fd.py, ops/pde.py, ops/perlin.py (the percentile threshold bitwise),
ops/ode.py (every method on the advection right-hand side at fp64, with
the adaptive step counts), synth/pathology.py, integrate_svf and the
surface meshes, and a whole item with pathology forced on from a random
shape with the one-hot segmentation warp. Random pieces take the JAX
side's draws (tests/_jax_draws.py)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brainfm_tpu.ops import fd as jfd
from brainfm_tpu.ops import ode as jode
from brainfm_tpu.ops import pde as jpde
from brainfm_tpu.ops import perlin as jperlin
from brainfm_tpu.synth import deform as jdeform
from brainfm_tpu.synth import engine as jengine
from brainfm_tpu.synth import pathology as jpath
from brainfm_tpu.synth import surface as jsurface
from brainfm_tpu.synth.params import SynthStatic as JSynthStatic
from brainfm_tpu_torch.ops import fd, ode, pde, perlin
from brainfm_tpu_torch.synth import deform, engine, pathology, surface
from brainfm_tpu_torch.synth.draws import Draws
from brainfm_tpu_torch.synth.params import SynthStatic
from brainfm_tpu_torch.utils import profiling

import _jax_draws as jd

# fp64 on both sides; the stencils are the same operations in the same
# order, so they agree exactly; the solvers sum their stages in another
# order (a few ulps a step)
FP64_ATOL = 1e-13
# fp32 Perlin noise: sin and cos of the lattice angles may differ by an
# ulp between XLA and PyTorch; the noise is O(1)
NOISE_ATOL = 1e-6
# fp32 item: as tests/test_torch_slice.py (a deformation grid summed in
# another order); the advected lesion probability went through ~70
# adaptive steps of fp32 stencils
TARGET_ATOL = 1e-4
PROB_ATOL = 1e-4
SEG_AGREE = 0.9999
# binarized pathology: a voxel at the threshold may flip
MASK_AGREE = 0.999


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- stencils

@pytest.mark.parametrize("kind", ["f", "b", "c"])
def test_gradients_match_jax(x64, kind):
    x = np.random.default_rng(0).standard_normal((2, 9, 10, 11))
    want = getattr(jfd, f"gradient_{kind}")(jnp.asarray(x),
                                            spacing=(1.0, 2.0, 0.5))
    got = getattr(fd, f"gradient_{kind}")(_t(x), spacing=(1.0, 2.0, 0.5))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_curl_and_advection_match_jax(x64):
    rng = np.random.default_rng(1)
    a, b, c = (rng.standard_normal((9, 10, 11)) for _ in range(3))
    for w, g in zip(jfd.curl_3d(*map(jnp.asarray, (a, b, c))),
                    fd.curl_3d(*map(_t, (a, b, c)))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    v = [5 * rng.standard_normal((9, 10, 11)) for _ in range(3)]
    np.testing.assert_array_equal(
        pde.apply_neumann_bc(_t(a)).numpy(),
        np.asarray(jpde.apply_neumann_bc(jnp.asarray(a))))
    for axis in range(3):
        np.testing.assert_array_equal(
            pde.upwind_gradient(_t(a), _t(v[axis]), axis).numpy(),
            np.asarray(jpde.upwind_gradient(jnp.asarray(a),
                                            jnp.asarray(v[axis]), axis)))
    for bc in ("neumann", "none"):
        np.testing.assert_array_equal(
            pde.advect_rhs(_t(a), *map(_t, v), bc=bc).numpy(),
            np.asarray(jpde.advect_rhs(jnp.asarray(a),
                                       *map(jnp.asarray, v), bc=bc)))


# ------------------------------------------------------------------ perlin

@pytest.mark.parametrize("tileable", [(False, False, False),
                                      (True, False, False),
                                      (True, True, True)])
def test_perlin_noise_matches_jax(tileable):
    key = jax.random.PRNGKey(3)
    want = jperlin.perlin_noise_3d(key, (16, 12, 8), (2, 3, 2), tileable)
    got = perlin.perlin_noise_3d(Draws(given=jd.perlin_draws(key, (2, 3, 2))),
                                 (16, 12, 8), (2, 3, 2), tileable)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=NOISE_ATOL)


def test_fractal_noise_and_velocity_match_jax():
    key = jax.random.PRNGKey(4)
    want = jperlin.fractal_noise_3d(key, (8, 8, 8), (2, 2, 2), octaves=2)
    # fractal_noise_3d splits the key once per octave
    keys = []
    k = key
    for _ in range(2):
        k, sub = jax.random.split(k)
        keys.append(sub)
    draws = {"octave": [jd.perlin_draws(s, (2 * 2 ** i,) * 3)
                        for i, s in enumerate(keys)]}
    got = perlin.fractal_noise_3d(Draws(given=draws), (8, 8, 8), (2, 2, 2),
                                  octaves=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=NOISE_ATOL)
    wv = jperlin.velocity_3d(key, (8, 8, 8), (2, 2, 2), 500.0)
    gv = perlin.velocity_3d(Draws(given=jd.velocity_draws(key, (2, 2, 2))),
                            (8, 8, 8), (2, 2, 2), 500.0)
    for k in ("Vx", "Vy", "Vz"):
        np.testing.assert_allclose(gv[k].numpy(), np.asarray(wv[k]),
                                   atol=500 * NOISE_ATOL)


@pytest.mark.parametrize("q", [0.0, 12.3, 20.0, 50.0, 85.0, 97.16, 99.9,
                               100.0])
def test_percentile_threshold_is_bitwise_jax(q):
    """On the same fp32 input (ties among the values too) the threshold
    equals the JAX package's sort-free form bit for bit, run op by op (the
    float32 rank, its floor and ceil order statistics, low*lw + high*hw,
    each rounded). It equals jnp.percentile bit for bit where the rank and
    the lerp's products are exact (q = 0, 20, 50, 100 here): elsewhere
    XLA's CPU backend fuses the rank and the lerp into multiply-adds
    inside jit, which moves jnp.percentile (and the jitted sort-free form)
    by an ulp on some inputs (ROADMAP Queue 3)."""
    rng = np.random.default_rng(int(q * 10))
    x = rng.standard_normal((16, 16, 16)).astype(np.float32)
    x.reshape(-1)[::7] = x.reshape(-1)[3]    # ties
    qf = np.float32(q)
    got = perlin.percentile_nosort(torch.from_numpy(x), torch.tensor(qf))
    nosort = jperlin.percentile_nosort(jnp.asarray(x), jnp.asarray(qf))
    assert got.numpy().tobytes() == np.asarray(nosort).tobytes()
    if q in (0.0, 20.0, 50.0, 100.0):
        want = jnp.percentile(jnp.asarray(x), jnp.asarray(qf))
        assert got.numpy().tobytes() == np.asarray(want).tobytes()


def test_shape_3d_matches_jax():
    key = jax.random.PRNGKey(5)
    q = np.float32(93.7)
    wm, wp = jperlin.shape_3d(key, (16, 16, 16), (2, 2, 2), jnp.asarray(q))
    gm, gp = perlin.shape_3d(Draws(given=jd.perlin_draws(key, (2, 2, 2))),
                             (16, 16, 16), (2, 2, 2), torch.tensor(q))
    assert np.mean(gm.numpy() == np.asarray(wm)) >= MASK_AGREE
    assert 0.05 < float(gm.mean()) < 0.08
    ok = gm.numpy() == np.asarray(wm)
    np.testing.assert_allclose(gp.numpy()[ok], np.asarray(wp)[ok],
                               atol=NOISE_ATOL)


# --------------------------------------------------------------------- ODE

@pytest.fixture(scope="module")
def advection():
    """A 12^3 lesion-like blob and a divergence-free velocity (fp64)."""
    vel = jperlin.velocity_3d(jax.random.PRNGKey(1), (12, 12, 12), (2, 2, 2),
                              50.0)
    blob = jperlin.shape_3d(jax.random.PRNGKey(2), (12, 12, 12), (2, 2, 2),
                            90.0)[1]
    return ({k: np.asarray(v, np.float64) for k, v in vel.items()},
            np.asarray(blob, np.float64))


def _rhs_pair(V):
    """The JAX right-hand side (counting its evaluations at run time) and
    the port's."""
    count = [0]

    def bump():
        count[0] += 1

    def jf(t, y):
        jax.debug.callback(bump)
        return jpde.advect_rhs(y, *(jnp.asarray(V[k])
                                    for k in ("Vx", "Vy", "Vz")))

    def tf(t, y):
        return pde.advect_rhs(y, *(_t(V[k]) for k in ("Vx", "Vy", "Vz")))
    return jf, tf, count


@pytest.mark.parametrize("method", ["euler", "midpoint", "rk4",
                                    "explicit_adams", "fixed_adams", "adams",
                                    "dopri5", "tsit5"])
def test_odeint_matches_jax_with_step_counts(x64, advection, method):
    """Every solver through 5 output times (Adams' start plus one step)
    at fp64; the right-hand side is evaluated as often on both sides, so
    the adaptive ones take the same steps (FSAL: 1 + 6 per step)."""
    V, y0 = advection
    jf, tf, count = _rhs_pair(V)
    ts = np.arange(5) * 0.1
    want = jax.jit(lambda y, t: jode.odeint(jf, y, t, method=method))(
        jnp.asarray(y0), jnp.asarray(ts))
    with profiling.recording():
        got = ode.odeint(tf, _t(y0), ts, method=method)
    stats = profiling.COUNTS
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FP64_ATOL)
    assert stats["ode.evals"] == count[0]
    if method in ("adams", "dopri5", "tsit5"):
        assert stats["ode.evals"] == 1 + 6 * stats["ode.steps"]
        assert stats["ode.steps"] > 4 * 2 and stats["ode.rejected"] >= 1


@pytest.mark.parametrize("method", ["rk4", "dopri5", "tsit5"])
def test_odeint_masked_final_matches_jax(x64, advection, method):
    """y(t[nt-1]) for nt = 1, 3, 6 of a 6-point grid, with the step size
    and the first stage carried across intervals."""
    V, y0 = advection
    ts = np.arange(6) * 0.1
    jf, tf, count = _rhs_pair(V)
    run = jax.jit(lambda y, t, nt: jode.odeint_masked_final(
        jf, y, t, nt, dt=0.1, method=method))
    for nt in (1, 3, 6):
        count[0] = 0
        want = run(jnp.asarray(y0), jnp.asarray(ts), nt)
        with profiling.recording():
            got = ode.odeint_masked_final(tf, _t(y0), ts, nt, dt=0.1,
                                          method=method)
        stats = profiling.COUNTS
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=FP64_ATOL)
        if method != "rk4":   # the JAX scan runs masked rk4 steps too
            assert stats["ode.evals"] == count[0], nt


# --------------------------------------------------------------- pathology

def test_binarize_and_encode_match_jax():
    rng = np.random.default_rng(6)
    p = rng.random((12, 13, 14)).astype(np.float32)
    np.testing.assert_array_equal(pathology.binarize(_t(p), 0.5).numpy(),
                                  np.asarray(jpath.binarize(jnp.asarray(p),
                                                            0.5)))
    img = (100 * rng.random((12, 13, 14))).astype(np.float32)
    P = (rng.random((12, 13, 14)) < 0.2).astype(np.float32)
    pprob = rng.random((12, 13, 14)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    for direction in (0.0, 1.0):
        want = jpath.encode_pathology(key, jnp.asarray(img), jnp.asarray(P),
                                      jnp.asarray(pprob),
                                      jnp.float32(direction))
        got = pathology.encode_pathology(
            Draws(given=jd.encode_draws(key, P.shape)), _t(img), _t(P),
            _t(pprob), torch.tensor(direction))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-4)
    assert float(pathology.pathology_direction(Draws(), "T2")) == 1.0
    assert float(pathology.pathology_direction(Draws(), "CT")) == 0.0


def test_augment_pathology_matches_jax():
    """fp32, the generator's velocity scale (v_multiplier 500) and dopri5;
    a key whose nt draw advects."""
    cfg = JSynthStatic(size=(16, 16, 16), augment_pathology=True, max_nt=4)
    p0 = np.asarray(jperlin.shape_3d(jax.random.PRNGKey(2), (16, 16, 16),
                                     (2, 2, 2), 90.0)[1])
    key = jax.random.PRNGKey(1)
    draws = jd.augment_pathology_draws(key, cfg)
    assert int(draws["nt"]) > 1
    want = jpath.augment_pathology(key, jnp.asarray(p0), cfg)
    with profiling.recording():
        got = pathology.augment_pathology(
            Draws(given=draws), _t(p0),
            SynthStatic(**dataclasses.asdict(cfg)))
    stats = profiling.COUNTS
    assert stats["ode.nt"] == int(draws["nt"]) and stats["ode.steps"] > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PROB_ATOL)


# ---------------------------------------------------------------- surfaces

def test_integrate_svf_matches_jax(x64):
    F = 2 * np.random.default_rng(8).standard_normal((10, 11, 12, 3))
    wf, wn = jdeform.integrate_svf(jnp.asarray(F), 4)
    gf, gn = deform.integrate_svf(_t(F), 4)
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), atol=FP64_ATOL)
    np.testing.assert_allclose(gn.numpy(), np.asarray(wn), atol=FP64_ATOL)


@pytest.mark.parametrize("flip", [False, True])
def test_deform_surfaces_matches_jax(tmp_path, flip):
    """Meshes from a .mat sidecar (scipy) through the inverse affine and a
    negative SVF, with the flip's remap and hemisphere swap."""
    from scipy.io import savemat

    rng = np.random.default_rng(9)
    surfs = {}
    for h in ("lw", "rw", "lp", "rp"):
        surfs[f"V{h}"] = rng.uniform(2, 14, (50, 3))
        surfs[f"F{h}"] = rng.integers(0, 50, (30, 3))
    path = str(tmp_path / "surf.mat")
    savemat(path, surfs)
    loaded = surface.load_surfaces_mat(path)
    assert set(loaded) == set(jsurface.load_surfaces_mat(path))
    A = np.eye(3, dtype=np.float32) + 0.05 * rng.standard_normal((3, 3))
    c2 = np.float32([7.5, 8.0, 7.0])
    Fneg = rng.standard_normal((16, 16, 16, 3)).astype(np.float32)
    want = jsurface.deform_surfaces(loaded, A, c2, jnp.asarray(Fneg), flip,
                                    (16, 16, 16))
    got = surface.deform_surfaces(loaded, A, c2, torch.from_numpy(Fneg), flip,
                                  (16, 16, 16))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)


# -------------------------------------------------------------------- item

def test_pathology_item_random_shape_one_hots_matches_jax():
    """A whole synth item (S=2, 24^3 from a 32^3 bank) with pathology
    forced on from a random Perlin shape, advected by dopri5, encoded
    into each sample behind its keep mask, and the segmentation target
    warped as a one-hot (deform_one_hots: K1 linear on 56 channels)."""
    tasks = ("T1", "segmentation", "pathology", "bias_field")
    jcfg = JSynthStatic(size=(24, 24, 24), all_samples=2, mild_samples=1,
                        pathology_prob=1.0, random_shape_prob=1.0,
                        augment_pathology=True, mix_synth_prob=0.2,
                        deform_one_hots=True)
    tcfg = SynthStatic(**dataclasses.asdict(jcfg))
    jbank = jengine.SubjectBank((32, 32, 32))
    jbank.add_debug_subject(seed=0, extent=(28, 30, 29))
    tbank = engine.SubjectBank((32, 32, 32))
    tbank.add_debug_subject(seed=0, extent=(28, 30, 29))
    jknobs = jengine.build_knobs_stack(jcfg, "synth")
    key = jax.random.PRNGKey(10)   # flip on, nt 7: advected, non-empty
    jt, js = jengine.synth_item(key, jbank.to_device(0), jcfg, tasks,
                                "synth", jknobs)
    draws = jd.item_draws(key, jcfg, "synth",
                          {k: np.asarray(v) for k, v in jknobs.items()},
                          (32, 32, 32), tasks=tasks)
    with profiling.recording():
        tt, ts = engine.synth_item(None, tbank.to_device(0, "cpu"), tcfg,
                                   tasks, "synth",
                                   engine.build_knobs_stack(tcfg, "synth"),
                                   draws=draws)
    spans = {s.name for s in profiling.SPANS}
    assert profiling.COUNTS["ode.steps"] > 0 and "gen.shape" in spans
    assert set(tt) == set(jt)
    p = tt["pathology"].numpy()
    assert p.sum() > 0 and np.mean(p == np.asarray(jt["pathology"])) \
        >= MASK_AGREE
    np.testing.assert_allclose(tt["pathology_prob"].numpy(),
                               np.asarray(jt["pathology_prob"]),
                               atol=PROB_ATOL)
    seg_t, seg_j = tt["segmentation"].numpy(), np.asarray(jt["segmentation"])
    assert seg_t.shape == seg_j.shape == (24, 24, 24, 56)
    np.testing.assert_allclose(seg_t, seg_j, atol=TARGET_ATOL)
    assert np.mean(seg_t.argmax(-1) == seg_j.argmax(-1)) >= SEG_AGREE
    np.testing.assert_allclose(tt["T1"].numpy(), np.asarray(jt["T1"]),
                               atol=TARGET_ATOL)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   atol=TARGET_ATOL, err_msg=k)
