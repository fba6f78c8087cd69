"""Shared set-up of the model-variant tests, one file per variant of
VARIANTS (tests/test_torch_variants.py: joint_age; test_torch_variant_sep.py;
test_torch_variant_critic.py): the configs cut to f_maps 8 and 3 levels,
each variant's JAX reference (processed cfg, model, fp64 params,
criterion, critic) built once per test module by `variant_ref`, the port's
model holding the same params, and the forward, round-trip and train-step
checks every variant runs."""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brainfm_tpu.config import AttrDict as JAttrDict
from brainfm_tpu.config import load_config as jload
from brainfm_tpu.models import build_model as jbuild
from brainfm_tpu.models import build as jbuildmod
from brainfm_tpu.models.build import apply_processors as japply
from brainfm_tpu.models.criterion import make_criterion as jcriterion
from brainfm_tpu.models.torch_import import torch_to_flax_params
from brainfm_tpu.train import step as jstep
from brainfm_tpu_torch.config import load_config as tload
from brainfm_tpu_torch.models import (apply_processors,
                                      build_critic_from_cfg, build_model,
                                      from_jax_params)
from brainfm_tpu_torch.models.criterion import make_criterion
from brainfm_tpu_torch.models.heads import scalar_head_width
from brainfm_tpu_torch.train.step import (TrainState, build_optimizer,
                                          make_train_step)

from _torch_train_util import (jax_params_as_port, joint_cfg, np_batch,
                               port_params, rel_l2, to_jax, to_torch)

# fp64 both sides; GroupNorm's variance formula and summation order leave
# ~1e-11 differences (tests/test_torch_model.py)
ATOL = 1e-9
LOSS_RTOL = 1e-10
PARAM_REL_L2 = 1e-9
LR, WD = 1e-3, 1e-2
LEVELS = 3
SIZE = (32, 32, 32)
# trainer config, generator config, extra cfg keys
VARIANTS = {"joint_age": ("joint_age", "brain_id_age", {}),
            "sep": ("sep", "twostage", {}),
            "critic": ("joint", "brain_id",
                       {"losses.implicit_pathol": True, "critic_f_maps": 8,
                        "critic_num_levels": LEVELS})}


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def variant_cfg(load, name, size=SIZE):
    train, gen, over = VARIANTS[name]
    cfg = joint_cfg(load, f_maps=8, num_levels=LEVELS, size=size, gen=gen,
                    train=train)
    cfg.optimizer, cfg.lr, cfg.weight_decay = "adamw", LR, WD
    for k, v in over.items():
        node = cfg
        *parents, leaf = k.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = v
    return cfg


def variant_batch(seed, n_labels, size=SIZE, S=4):
    """np_batch's targets with the age and pathology targets added."""
    rng = np.random.default_rng(seed + 100)
    batch = np_batch(seed, n_labels, size=size, S=S)
    batch["targets"]["age"] = rng.uniform(20.0, 90.0, (1,))
    batch["targets"]["pathology"] = (rng.random((1, 1, *size, 1))
                                     < 0.2).astype(np.float64)
    return batch


def jax_variant(name, size=SIZE, seed=0):
    """The JAX package's processed cfg, model and fp64 params (numpy)."""
    jcfg, jm = jbuild(variant_cfg(jload, name, size),
                      compute_dtype=jnp.float64)
    x = jnp.zeros((1, *size, 1), jnp.float64)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), x)
    return jcfg, jm, jax.tree.map(lambda a: np.asarray(a, np.float64), params)


def port_variant(name, params, size=SIZE):
    cfg, model = build_model(variant_cfg(tload, name, size), device="cpu")
    model = model.double()
    model.load_state_dict(from_jax_params(params), strict=True)
    return cfg, model


def jax_critic(jcfg):
    """The JAX critic of the critic variant at fp64 (its random init)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        critic, params, key = jbuildmod.build_critic_from_cfg(
            jcfg, compute_dtype=jnp.float64)
    return critic, jax.tree.map(lambda a: np.asarray(a, np.float64),
                                params), key


def port_critic(cfg, params):
    with pytest.warns(UserWarning, match="RANDOM"):
        critic, key = build_critic_from_cfg(cfg, device="cpu")
    critic.double().load_state_dict(from_jax_params(params), strict=True)
    return critic, key


def variant_ref(name):
    """The JAX reference of variant `name` at SIZE, seed 0: cfg, model,
    params, criterion, critic (the critic variant's) and the step batch;
    each test module builds it once and shares it."""
    jcfg, jm, params = jax_variant(name)
    _, jw, jfn = jcriterion(jcfg)
    critic = jax_critic(jcfg) if name == "critic" else None
    return dict(jcfg=jcfg, jm=jm, params=params, jw=jw, jfn=jfn,
                critic=critic, batch=variant_batch(0, jcfg.n_labels))


def assert_outputs_match(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], list):
            assert len(got[k]) == len(want[k]), k
            for a, b in zip(got[k], want[k]):
                assert tuple(a.shape) == b.shape, k
                np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                           atol=ATOL, err_msg=k)
        else:
            assert tuple(got[k].shape) == want[k].shape, k
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       np.asarray(want[k]), atol=ATOL,
                                       err_msg=k)


def check_forward(name, size, ref=None):
    """Every output and feature level of variant `name` on a (size)^3
    volume, before and after the processors, against the JAX model; `ref`
    (variant_ref's) stands for the JAX build at SIZE."""
    shape = (size,) * 3
    x = np.random.default_rng(size).standard_normal((2, *shape, 1))
    if ref is not None and shape == SIZE:
        jcfg, jm, params = ref["jcfg"], ref["jm"], ref["params"]
    else:
        jcfg, jm, params = jax_variant(name, shape)
    raw = jax.jit(jm.apply)(params, jnp.asarray(x))
    cfg, model = port_variant(name, params, shape)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
        assert_outputs_match(out, raw)
        assert_outputs_match(apply_processors(out, cfg), japply(raw, jcfg))
    if name == "joint_age":
        assert tuple(out["age"].shape) == (2,)
        w = model.head.final_linear1_age.weight
        assert tuple(w.shape) == (160, scalar_head_width(shape))
        assert scalar_head_width(shape) == 4 * (size // 16) ** 3
    else:
        assert {"feat_normal", "feat_pathology", "pathology"} <= set(out)
        assert "pathology" not in dict(model.head_normal.named_children())


def check_round_trip(name):
    """The state dict from_jax_params gives names every tensor of the
    port's model; for the age model torch_to_flax_params (the JAX
    package's reader of reference state dicts: pool_layers,
    final_linear*) gives the flax tree back exactly."""
    _, _, params = jax_variant(name, (16, 16, 16), seed=3)
    sd = from_jax_params(params)
    _, model = build_model(variant_cfg(tload, name, (16, 16, 16)),
                           device="cpu")
    assert set(model.state_dict()) == set(sd)
    if name == "joint_age":
        assert tuple(sd["head.pool_layers.3.main.weight"].shape) == \
            (4, 16, 3, 3, 3)
        back = torch_to_flax_params({k: v.numpy() for k, v in sd.items()})
        flat_a = jax.tree_util.tree_flatten_with_path(params["params"])[0]
        flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            np.testing.assert_array_equal(flat_b[path], leaf)


def check_step(v, name, accum):
    """One fp64 AdamW step of variant `name` (its reference `v`),
    monolithic or in `accum` sample microbatches, against the JAX
    package's jitted make_train_step: metrics rtol 1e-10, params rel-L2
    < 1e-9 per tensor; a critic's weights stay as they were."""
    jcfg = JAttrDict(dict(v["jcfg"]))
    jopt = jstep.build_optimizer(jcfg)
    kw = {}
    jbatch = to_jax(v["batch"])
    if v["critic"] is not None:
        jcritic, jcparams, jkey = v["critic"]
        kw = dict(critic=jcritic, critic_image_key=jkey)
        jbatch["critic_params"] = jcparams
    jfn = jstep.make_train_step(v["jm"], jcfg, v["jw"], v["jfn"], jopt,
                                donate=False, sample_accum=accum, **kw)
    s0 = jstep.TrainState(v["params"], jopt.init(v["params"]),
                          jnp.zeros((), jnp.int32))
    js, jm_ = jfn(s0, jbatch, LR, WD)

    cfg, model = port_variant(name, v["params"])
    _, w, loss_fn = make_criterion(cfg)
    critic, key = None, "T1"
    if v["critic"] is not None:
        critic, key = port_critic(cfg, v["critic"][1])
        c0 = {k: t.clone() for k, t in critic.state_dict().items()}
    opt = build_optimizer(cfg, model.parameters())
    step = make_train_step(model, cfg, w, loss_fn, opt, sample_accum=accum,
                           amp=False, critic=critic, critic_image_key=key)
    state, pm = step(TrainState(model, opt, 0), to_torch(v["batch"]), LR, WD)
    assert state.step == 1 and float(pm["skipped"]) == 0.0
    assert set(pm) == set(jm_)
    if name == "joint_age":
        assert "loss_age" in pm
    if critic is not None:
        assert {"loss_implicit_pathol_ce", "loss_implicit_pathol_dice"} <= \
            set(pm)
        assert all(torch.equal(c0[k], t)
                   for k, t in critic.state_dict().items())
    for k in jm_:
        np.testing.assert_allclose(float(pm[k]), float(jm_[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    want = jax_params_as_port(js.params)
    got = port_params(state.model)
    for k in want:
        assert rel_l2(got[k], want[k]) < PARAM_REL_L2, k
