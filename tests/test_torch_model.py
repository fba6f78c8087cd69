"""brainfm_tpu_torch/models against brainfm_tpu/models on the CPU at fp64:
the joint config cut to f_maps 8, at num_levels 5 and 6, on an even (32^3)
and an odd (33^3) volume. The JAX model's params, converted by
from_jax_params, drive the port; every head output and every feature level
must agree. Both sides run the JAX package's decoder forms (the
phase-folded pair conv and pair GroupNorm, the fused GroupNorm), the port
its twins of ops/groupnorm.py and models/unet3d.py
(tests/test_torch_groupnorm.py)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brainfm_tpu.config import load_config as jload
from brainfm_tpu.models import build_model as jbuild
from brainfm_tpu.models.build import apply_processors as japply
from brainfm_tpu.models.torch_import import torch_to_flax_params
from brainfm_tpu_torch.config import load_config as tload
from brainfm_tpu_torch.config import merge_missing
from brainfm_tpu_torch.models import (apply_processors, build_model,
                                      from_jax_params)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp64 both sides; GroupNorm variance as E[x^2]-E[x]^2 (JAX) vs two-pass
# (PyTorch) and the unit-vector normalization of the last feature leave
# ~1e-11 differences
ATOL = 1e-9


def joint_cfg(load, f_maps=8, num_levels=5):
    gen = load([os.path.join(ROOT, "cfgs/generator/default.yaml"),
                "brain_id"], cfg_dir=os.path.join(ROOT, "cfgs/generator/train"))
    tr = load([os.path.join(ROOT, "cfgs/trainer/default_train.yaml"),
               "joint"], cfg_dir=os.path.join(ROOT, "cfgs/trainer/train"))
    merge_missing(tr, gen)
    tr.f_maps, tr.num_levels, tr.task_f_maps = f_maps, num_levels, [f_maps]
    return tr


def jax_model(num_levels, x, dtype, seed=0):
    """brainfm_tpu's joint model and params (numpy, `dtype`)."""
    jcfg, jm = jbuild(joint_cfg(jload, num_levels=num_levels),
                      compute_dtype=jnp.dtype(dtype))
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(x[:1]))
    return jcfg, jm, jax.tree.map(lambda a: np.asarray(a, dtype), params)


def port_model(num_levels, params, dtype):
    cfg, model = build_model(joint_cfg(tload, num_levels=num_levels),
                             device="cpu")
    model = model.to(torch.float64 if dtype == np.float64 else torch.float32)
    model.load_state_dict(from_jax_params(params), strict=True)
    return cfg, model.eval()


@pytest.fixture(scope="module")
def fp64_models():
    """jax_model(num_levels, x, np.float64), built once per num_levels: the
    params depend on the seed and the layer shapes, not on x's extent, so
    the even and the odd volume share them."""
    built = {}

    def get(num_levels, x):
        if num_levels not in built:
            built[num_levels] = jax_model(num_levels, x, np.float64)
        return built[num_levels]
    return get


@pytest.mark.parametrize("num_levels", [5, 6])
@pytest.mark.parametrize("size", [32, 33])
def test_joint_forward_matches_jax_fp64(fp64_models, num_levels, size):
    jax.config.update("jax_enable_x64", True)
    try:
        x = np.random.default_rng(size).standard_normal(
            (2, size, size, size, 1))
        jcfg, jm, params = fp64_models(num_levels, x)
        want = japply(jax.jit(jm.apply)(params, jnp.asarray(x)), jcfg)
        cfg, model = port_model(num_levels, params, np.float64)
        with torch.no_grad():
            got = apply_processors(model(torch.from_numpy(x)), cfg)
        assert set(got) == set(want)
        assert len(got["feat"]) == len(want["feat"]) == num_levels
        for a, b in zip(got["feat"], want["feat"]):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
        for k in want:
            if k != "feat":
                assert tuple(got[k].shape) == want[k].shape, k
                np.testing.assert_allclose(got[k].numpy(),
                                           np.asarray(want[k]), atol=ATOL,
                                           err_msg=k)
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("num_levels", [5, 6])
def test_params_round_trip_is_identity(num_levels):
    """flax -> port state dict -> flax (torch_to_flax_params) and
    state dict -> flax -> state dict both give back their input exactly;
    the conv layout is (kd,kh,kw,cin,cout) <-> (cout,cin,kd,kh,kw)."""
    x = np.zeros((1, 32, 32, 32, 1), np.float32)
    _, _, params = jax_model(num_levels, x, np.float32, seed=num_levels)
    sd = from_jax_params(params)
    back = torch_to_flax_params({k: v.numpy() for k, v in sd.items()})
    flat_a = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b) == len(sd)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    sd2 = from_jax_params(back)
    assert sd2.keys() == sd.keys()
    for k in sd:
        assert torch.equal(sd2[k], sd[k]), k
    w = sd["backbone.encoders.1.basic_module.SingleConv2.conv.weight"]
    assert tuple(w.shape) == (16, 8, 3, 3, 3)
    # the port's own modules name every tensor the same way
    _, model = build_model(joint_cfg(tload, num_levels=num_levels),
                           device="cpu")
    assert set(model.state_dict()) == set(sd)
