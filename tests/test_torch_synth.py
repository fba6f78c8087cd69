"""brainfm_tpu_torch config and generator pieces against brainfm_tpu on the
CPU, each random piece fed the JAX side's draws (tests/_jax_draws.py)."""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brainfm_tpu import config as jconfig
from brainfm_tpu.synth import augment as jaug
from brainfm_tpu.synth import constants as jconst
from brainfm_tpu.synth import deform as jdeform
from brainfm_tpu.synth import gmm as jgmm
from brainfm_tpu.synth import params as jparams
from brainfm_tpu_torch import config as tconfig
from brainfm_tpu_torch.synth import augment as taug
from brainfm_tpu_torch.synth import constants as tconst
from brainfm_tpu_torch.synth import deform as tdeform
from brainfm_tpu_torch.synth import gmm as tgmm
from brainfm_tpu_torch.synth import params as tparams
from brainfm_tpu_torch.synth.draws import Draws

import _jax_draws as jd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(os.path.relpath(p, ROOT) for p in
               glob.glob(os.path.join(ROOT, "cfgs/**/*.yaml"), recursive=True))
GEN_TRAIN = sorted(os.path.basename(p)[:-5] for p in
                   glob.glob(os.path.join(ROOT, "cfgs/generator/train/*.yaml")))

# fp32 on both sides; sums and matrix products in other orders
ATOL = 1e-5


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, atol=ATOL, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("path", YAMLS)
def test_config_loads_like_jax(path):
    f = os.path.join(ROOT, path)
    assert tconfig.load_config([f]) == jconfig.load_config([f])


def _gen_cfg(load, name):
    return load([os.path.join(ROOT, "cfgs/generator/default.yaml"), name],
                cfg_dir=os.path.join(ROOT, "cfgs/generator/train"))


@pytest.mark.parametrize("name", GEN_TRAIN)
def test_synth_static_from_cfg_like_jax(name):
    t = tparams.SynthStatic.from_cfg(_gen_cfg(tconfig.load_config, name))
    j = jparams.SynthStatic.from_cfg(_gen_cfg(jconfig.load_config, name))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_absent_keys_read_none_and_merge_missing():
    cfg = tconfig.AttrDict.from_nested({"a": {"b": None}})
    assert cfg.nope is None and cfg.a.nope is None
    tconfig.merge_missing(cfg, {"a": {"b": 2, "c": 3}, "d": 4})
    assert cfg == {"a": {"b": 2, "c": 3}, "d": 4}


def test_label_tables_like_jax():
    assert tconst.LABELS_LEFT == jconst.LABELS_LEFT
    assert tconst.LABELS_EXTRACEREBRAL == jconst.LABELS_EXTRACEREBRAL
    assert tconst.N_NEUTRAL == jconst.N_NEUTRAL
    assert tconst.CT_BRIGHTNESS_GROUP == jconst.CT_BRIGHTNESS_GROUP
    for labels in (jconst.LABELS_LEFT, jconst.LABELS_EXTRACEREBRAL):
        np.testing.assert_array_equal(tconst.build_lut(labels),
                                      jconst.build_lut(labels))
        np.testing.assert_array_equal(tconst.build_vflip(len(labels)),
                                      jconst.build_vflip(len(labels)))
    assert tconst.build_lut(jconst.LABELS_EXTRACEREBRAL).shape == (10000,)


@pytest.fixture(scope="module")
def scfg():
    return jparams.SynthStatic(size=(24, 26, 28), photo_prob=0.5,
                               random_shift=True)


def _tcfg(jcfg):
    return tparams.SynthStatic(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("seed", range(6))
def test_sample_setup_like_jax(seed):
    """Every branch of the acquisition model shows up over the seeds."""
    key = jax.random.PRNGKey(seed)
    for jcfg in (jparams.SynthStatic(photo_prob=0.5),
                 jparams.SynthStatic(low_res_only=True),
                 jparams.SynthStatic(left_hemis_only=True)):
        want = jparams.sample_setup(key, jcfg)
        got = tparams.sample_setup(Draws(given=jd.setup_draws(key)),
                                   _tcfg(jcfg))
        for k in want:
            _close(got[k], want[k], atol=1e-6)


@pytest.mark.parametrize("seed", range(3))
def test_random_affine_and_grid_like_jax(scfg, seed):
    key = jax.random.PRNGKey(seed)
    shp = np.array([30.0, 31.0, 29.0], np.float32)
    ws, wA, wc = jdeform.random_affine(key, scfg, jnp.asarray(shp))
    ts, tA, tc = tdeform.random_affine(Draws(given=jd.affine_draws(key)),
                                       _tcfg(scfg), _t(shp))
    _close(ts, ws, 1e-6)
    _close(tA, wA, 1e-6)
    _close(tc, wc, 1e-5)
    F = np.random.default_rng(seed).standard_normal(
        (*scfg.size, 3)).astype(np.float32)
    want = jdeform.deform_grid(scfg, jnp.asarray(shp), wA, wc, jnp.asarray(F))
    got = tdeform.deform_grid(_tcfg(scfg), _t(shp), tA, tc, _t(F))
    for g, w in zip(got, want):
        _close(g, w, 1e-4)   # coordinates up to ~30: a few ulps


@pytest.mark.parametrize("photo", [0.0, 1.0])
def test_random_nonlinear_field_like_jax(scfg, photo):
    key = jax.random.PRNGKey(11)
    setup = {"photo_mode": jnp.float32(photo), "spac": jnp.float32(4.3)}
    want, _ = jdeform.random_nonlinear_field(key, scfg, setup)
    got, _ = tdeform.random_nonlinear_field(
        Draws(given=jd.field_draws(key, scfg)), _tcfg(scfg),
        {k: _t(v) for k, v in setup.items()})
    assert got.shape == (*scfg.size, 3)
    _close(got, want, 1e-5)


def test_zoom_from_effective_like_jax():
    rng = np.random.default_rng(7)
    field = rng.standard_normal((9, 11, 6, 2)).astype(np.float32)
    eff = np.array([5.0, 11.0, 3.0], np.float32)
    want = jdeform.zoom_from_effective(jnp.asarray(field), jnp.asarray(eff),
                                       (20, 17, 12))
    got = tdeform.zoom_from_effective(_t(field), _t(eff), (20, 17, 12))
    _close(got, want)


@pytest.mark.parametrize("ct_prob", [0.0, 1.0])
def test_contrast_lut_like_jax(ct_prob):
    key = jax.random.PRNGKey(5)
    for photo in (0.0, 1.0):
        wm, ws = jgmm.sample_contrast_lut(key, ct_prob, jnp.float32(photo))
        tm, ts = tgmm.sample_contrast_lut(
            Draws(given=jd.contrast_draws(key, ct_prob)), ct_prob,
            torch.tensor(photo))
        _close(tm, wm, 1e-4)   # means up to 225
        _close(ts, ws, 1e-5)


@pytest.fixture(scope="module")
def knobs():
    return {"gamma_std": np.float32(0.1), "bf_scale_min": np.float32(0.02),
            "bf_scale_max": np.float32(0.04), "bf_std_min": np.float32(0.1),
            "bf_std_max": np.float32(0.6), "noise_std_min": np.float32(5.0),
            "noise_std_max": np.float32(15.0)}


def _setup(photo):
    return {"photo_mode": np.float32(photo), "spac": np.float32(5.5),
            "thickness": np.array([1.0, 3.2, 5.9], np.float32),
            "resolution": np.array([1.0, 2.5, 4.1], np.float32),
            "flip": np.float32(0.0)}


@pytest.mark.parametrize("photo", [0.0, 1.0])
def test_augment_steps_like_jax(scfg, knobs, photo):
    """Each step on its own, with the draws the JAX step makes."""
    rng = np.random.default_rng(8)
    img = (rng.random(scfg.size) * 200).astype(np.float32)
    setup = _setup(photo)
    jsetup = {k: jnp.asarray(v) for k, v in setup.items()}
    tsetup = {k: _t(v) for k, v in setup.items()}
    tknobs = {k: _t(v) for k, v in knobs.items()}
    key = jax.random.PRNGKey(3)
    ov = jd.aug_overrides(key, scfg, knobs,
                          ("gamma", "bias_field", "resample", "noise"))
    d = Draws()

    _close(taug.gamma_transform(d, _t(img), tknobs["gamma_std"],
                                gamma=_t(ov["gamma"])),
           jaug.gamma_transform(key, jnp.asarray(img), knobs["gamma_std"],
                                gamma=jnp.asarray(ov["gamma"])), 1e-4)
    _close(taug.sample_bias_field(d, _tcfg(scfg), tsetup, tknobs,
                                  bf_scale=_t(ov["bf_scale"]),
                                  std=_t(ov["bf_std"]),
                                  small_noise=_t(ov["bf_small_noise"])),
           jaug.sample_bias_field(key, scfg, jsetup, knobs,
                                  bf_scale=ov["bf_scale"], std=ov["bf_std"],
                                  small_noise=ov["bf_small_noise"]))
    ws, wn = jaug.resample_resolution(key, jnp.asarray(img), scfg, jsetup,
                                      rnd=ov["resample_rnd"])
    ts, tn = taug.resample_resolution(d, _t(img), _tcfg(scfg), tsetup,
                                      rnd=_t(ov["resample_rnd"]))
    _close(tn, wn)
    _close(ts, ws, 1e-3)   # blurred values up to 200
    _close(taug.add_noise(d, _t(img), 5.0, 15.0, std=_t(ov["noise_std"]),
                          noise=_t(ov["noise_field"])),
           jaug.add_noise(key, jnp.asarray(img), 5.0, 15.0,
                          std=ov["noise_std"], noise=ov["noise_field"]), 1e-4)


@pytest.mark.parametrize("is_ct", [False, True])
def test_augment_chain_like_jax(scfg, knobs, is_ct):
    """The whole chain on the JAX chain's own draws (augment_chain
    overrides, made from the same key)."""
    rng = np.random.default_rng(9)
    img = (rng.random(scfg.size) * 200).astype(np.float32)
    setup = _setup(0.0)
    steps = ("gamma", "bias_field", "resample", "noise")
    key = jax.random.PRNGKey(4)
    want, waux = jaug.augment_chain(key, jnp.asarray(img), scfg,
                                    {k: jnp.asarray(v)
                                     for k, v in setup.items()},
                                    knobs, steps, is_ct=is_ct)
    got, taux = taug.augment_chain(
        Draws(), _t(img), _tcfg(scfg), {k: _t(v) for k, v in setup.items()},
        {k: _t(v) for k, v in knobs.items()}, steps, is_ct=is_ct,
        overrides=jd.aug_overrides(key, scfg, knobs, steps, is_ct))
    _close(got, want, 1e-3, 1e-4)   # values up to ~300
    assert set(taux) == set(waux)
    for k in waux:
        _close(taux[k], waux[k], 1e-3, 1e-4)


def test_draws_record_and_replay():
    """A recorded run replays exactly from its record."""
    rec = {}
    d = Draws(torch.Generator().manual_seed(0), given=None, record=rec)
    a = d.uniform("a", (3,))
    b = d.sub("s", 1).normal("b")
    replay = Draws(given=rec)
    assert torch.equal(replay.uniform("a", (3,)), a)
    assert torch.equal(replay.sub("s", 1).normal("b"), b)
    with pytest.raises(ValueError):
        Draws(given={"a": np.zeros(2)}).uniform("a", (3,))
