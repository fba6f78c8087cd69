"""The JAX generator's random draws, as named inputs for the PyTorch port.

jax.random and torch never give the same numbers, so the port's random
functions take their draws injected by name (brainfm_tpu_torch/synth/
draws.py). These helpers make each draw with exactly the key splits the
JAX functions use, so the two packages see the same numbers."""

import math

import jax
import jax.numpy as jnp
import numpy as np

from brainfm_tpu.synth.deform import small_field_buffer_shape

U, N = jax.random.uniform, jax.random.normal


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def setup_draws(key):
    """synth/params.py sample_setup + resolution_sampler."""
    keys = jax.random.split(key, 8)
    k1, k2, k3, k4 = jax.random.split(keys[5], 4)
    return _np({"photo_u": U(keys[0]), "pathol_u": U(keys[1]),
                "shape_u": U(keys[2]), "spac_u": U(keys[3]),
                "flip_n": N(keys[4]), "res_r": U(k1),
                "res_idx": jax.random.randint(k2, (), 0, 3),
                "res_u2": U(k3, (2,)), "res_u3": U(k4, (3,))})


def affine_draws(key):
    """synth/deform.py random_affine."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return _np({"rot_u": U(k1, (3,)), "shear_u": U(k2, (3,)),
                "scal_u": U(k3, (3,)), "shift_u": U(k4, (3,))})


def field_draws(key, cfg):
    """synth/deform.py random_nonlinear_field."""
    k1, k2, k3 = jax.random.split(key, 3)
    buf = small_field_buffer_shape(cfg)
    return _np({"scale_u": U(k1), "std_u": U(k2),
                "small_n": N(k3, (*buf, 3))})


def contrast_draws(key, ct_prob=0.0):
    """synth/gmm.py sample_contrast_lut."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    d = {"mus_u": U(k1, (256,)), "sigmas_u": U(k2, (256,)),
         "zero_bg_u": U(k5)}
    if ct_prob > 0:
        d.update(ct_u=U(k3), ct_levels_u=U(k4, (4,)))
    return _np(d)


def bias_buffer_shape(cfg):
    """The static buffer of synth/augment.py sample_bias_field."""
    frac1 = (1.0 / 2.5 if (cfg.photo_prob > 0 or cfg.left_hemis_only)
             else cfg.bf_scale_max)
    frac1 = max(cfg.bf_scale_max, frac1)
    return (int(math.ceil(cfg.bf_scale_max * cfg.size[0])) + 1,
            int(math.ceil(frac1 * cfg.size[1])) + 1,
            int(math.ceil(cfg.bf_scale_max * cfg.size[2])) + 1)


def aug_overrides(key, cfg, knobs, steps, is_ct=False):
    """synth/augment.py augment_chain's injected-draw overrides, made the
    way its steps make them from `key`."""
    keys = jax.random.split(key, 4)
    ov = {}
    for step in steps:
        if step == "gamma":
            ov["gamma"] = jnp.exp(knobs["gamma_std"] * N(keys[0]))
        elif step == "bias_field" and not is_ct:
            k1, k2, k3 = jax.random.split(keys[1], 3)
            ov["bf_scale"] = knobs["bf_scale_min"] + U(k1) * (
                knobs["bf_scale_max"] - knobs["bf_scale_min"])
            ov["bf_std"] = knobs["bf_std_min"] + (
                knobs["bf_std_max"] - knobs["bf_std_min"]) * U(k2)
            ov["bf_small_noise"] = N(k3, bias_buffer_shape(cfg))
        elif step == "resample":
            ov["resample_rnd"] = 0.85 + 0.3 * U(keys[2])
        elif step == "noise":
            k1, k2 = jax.random.split(keys[3])
            ov["noise_std"] = knobs["noise_std_min"] + (
                knobs["noise_std_max"] - knobs["noise_std_min"]) * U(k1)
            ov["noise_field"] = N(k2, tuple(cfg.size))
    return _np(ov)


def perlin_draws(key, res):
    """ops/perlin.py perlin_noise_3d: the lattice's theta and phi."""
    k1, k2 = jax.random.split(key)
    lattice = tuple(int(r) + 1 for r in res)
    return _np({"theta_u": U(k1, lattice), "phi_u": U(k2, lattice)})


def velocity_draws(key, res):
    """ops/perlin.py velocity_3d: three potentials."""
    return {"potential": [perlin_draws(k, res)
                          for k in jax.random.split(key, 3)]}


def random_shape_draws(key, cfg):
    """synth/pathology.py random_shape."""
    k1, k2 = jax.random.split(key)
    return {"percentile_u": np.asarray(U(k1)),
            "shape": perlin_draws(k2, cfg.perlin_res)}


def augment_pathology_draws(key, cfg):
    """synth/pathology.py augment_pathology."""
    k1, k2 = jax.random.split(key)
    return {"nt": np.asarray(jax.random.randint(k1, (), 1, cfg.max_nt + 1)),
            "velocity": velocity_draws(k2, cfg.perlin_res)}


def pathology_target_draws(key, cfg):
    """synth/engine.py _target_pathology (the draws of its `_on` branch)."""
    k1, k2 = jax.random.split(key)
    return {"shape": random_shape_draws(k1, cfg),
            "augment": augment_pathology_draws(k2, cfg)}


def encode_draws(key, shape):
    """synth/pathology.py encode_pathology."""
    k1, k2, k3 = jax.random.split(key, 3)
    return _np({"mus_u": U(k1, (10000,)), "sigmas_u": U(k2, (10000,)),
                "noise": N(k3, tuple(shape))})


def item_draws(key, cfg, input_mode, knobs_stack, gen_shape, tasks=()):
    """Every draw of synth/engine.py `_synth_item_impl` for `key`, nested
    as brainfm_tpu_torch's synth_item(draws=...) reads them."""
    k_setup, k_field, k_aff, k_tgt, k_samp = jax.random.split(key, 5)
    d = {"setup": setup_draws(k_setup), "affine": affine_draws(k_aff)}
    if cfg.nonlinear_transform:
        d["field"] = field_draws(k_field, cfg)
    pathology = "pathology" in tasks
    if pathology:
        d["pathology"] = pathology_target_draws(k_tgt, cfg)
    S = cfg.all_samples
    if input_mode == "synth":
        kl, kn = jax.random.split(jax.random.fold_in(k_samp, 10_000))
        d["synth"] = {
            "contrast": [contrast_draws(jax.random.fold_in(kl, i),
                                        cfg.ct_prob) for i in range(S)],
            "syn_noise": np.asarray(N(kn, (*gen_shape, S)))}
    samples = []
    for i in range(S):
        ki = jax.random.fold_in(k_samp, i)
        knobs = {k: v[i] for k, v in knobs_stack.items()}
        s = {}
        if input_mode == "synth":
            k3, k4, k5 = jax.random.split(ki, 3)
            if cfg.mix_synth_prob > 0:
                s.update(_np({"mix_u": U(k3), "mix_v": U(k4, (4,))}))
            k_enc, k_aug = jax.random.split(k5)
            steps = cfg.aug_steps_synth
        else:
            k_enc, k_aug = jax.random.split(jax.random.split(ki)[1])
            steps = cfg.aug_steps_real
        if pathology:
            s["encode"] = encode_draws(k_enc, cfg.size)
        s["aug"] = aug_overrides(k_aug, cfg, knobs, steps,
                                 is_ct=input_mode == "CT")
        samples.append(s)
    d["samples"] = samples
    return d
