"""The model variants of the shipped trainer configs against the JAX
package on the CPU at fp64, weights handed across by from_jax_params: the
pooled age head (joint_age.yaml with brain_id_age.yaml, on an even and an
odd volume), DepHead, UNet3DSep with the SepJoiner (sep.yaml on
twostage.yaml's generator), UNet2D and the frozen implicit-pathology
critic; then one train step of each (joint_age, sep, the critic-on
flagship; monolithic and with sample_accum 2) against the JAX package's
jitted make_train_step, and the critic's checkpoint handling. Models are
cut to f_maps 8 and 3 levels."""

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
from brainfm_tpu.models.heads import DepHead as JDepHead
from brainfm_tpu.models.torch_import import torch_to_flax_params
from brainfm_tpu.models.unet3d import UNet2D as JUNet2D
from brainfm_tpu.train import step as jstep
from brainfm_tpu_torch.config import AttrDict
from brainfm_tpu_torch.config import load_config as tload
from brainfm_tpu_torch.models import (DepHead, UNet2D, apply_processors,
                                      build_critic_from_cfg, build_model,
                                      from_jax_params,
                                      implicit_pathol_outputs)
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


def _assert_outputs_match(got, want):
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


# --------------------------------------------------------------- forwards

@pytest.mark.parametrize("name,size", [("joint_age", 32), ("joint_age", 36),
                                       ("sep", 32)])
def test_variant_forward_matches_jax(name, size):
    """Every output and feature level of the age model (36^3: the pools'
    floors, 36 -> 9 -> 2) and of the SepJoiner (both feature pyramids,
    the normal and pathology heads), before and after the processors."""
    shape = (size,) * 3
    x = np.random.default_rng(size).standard_normal((2, *shape, 1))
    jcfg, jm, params = jax_variant(name, shape)
    raw = jax.jit(jm.apply)(params, jnp.asarray(x))
    cfg, model = port_variant(name, params, shape)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
        _assert_outputs_match(out, raw)
        _assert_outputs_match(apply_processors(out, cfg), japply(raw, jcfg))
    if name == "joint_age":
        assert tuple(out["age"].shape) == (2,)
        w = model.head.final_linear1_age.weight
        assert tuple(w.shape) == (160, scalar_head_width(shape))
        assert scalar_head_width(shape) == 4 * (size // 16) ** 3
    else:
        assert {"feat_normal", "feat_pathology", "pathology"} <= set(out)
        assert "pathology" not in dict(model.head_normal.named_children())


@pytest.mark.parametrize("name", ["joint_age", "sep"])
def test_variant_params_round_trip(name):
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


def test_dephead_matches_jax():
    """DepHead: the image concatenated to the last feature, two ConvBlocks
    and the fused 1x1 convs."""
    rng = np.random.default_rng(7)
    feats = [rng.standard_normal((2, 6, 5, 7, 8))]
    image = rng.standard_normal((2, 6, 5, 7, 1))
    out_ch = {"T1": 1, "segmentation": 5, "age": -1}
    jh = JDepHead((8, 8, 4), out_ch, compute_dtype=jnp.float64)
    p = jh.init(jax.random.PRNGKey(1), [jnp.asarray(f) for f in feats],
                jnp.asarray(image))
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), p)
    want = jax.jit(jh.apply)(p, [jnp.asarray(f) for f in feats],
                             jnp.asarray(image))
    head = DepHead(8, (8, 8, 4), out_ch).double()
    sd = from_jax_params({"head": p["params"]})
    head.load_state_dict({k.removeprefix("head."): v for k, v in sd.items()},
                         strict=True)
    with torch.no_grad():
        got = head([torch.from_numpy(f).movedim(-1, 1) for f in feats],
                   torch.from_numpy(image).movedim(-1, 1))
    assert set(got) == set(want) == {"T1", "segmentation"}
    for k in want:
        np.testing.assert_allclose(got[k].movedim(1, -1).numpy(),
                                   np.asarray(want[k]), atol=ATOL, err_msg=k)


@pytest.mark.parametrize("hw", [(32, 32), (33, 30)])
def test_unet2d_matches_jax(hw):
    """UNet2D (2-D convs, pools and upsampling) at every feature level,
    even and odd extents."""
    x = np.random.default_rng(2).standard_normal((2, *hw, 1))
    jm = JUNet2D(f_maps=8, num_levels=LEVELS, compute_dtype=jnp.float64)
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), p)
    want = jax.jit(lambda q, a: jm.apply(q, a, method=jm.get_feature))(
        p, jnp.asarray(x))
    model = UNet2D(f_maps=8, num_levels=LEVELS).double()
    sd = from_jax_params({"backbone": p["params"]})
    model.load_state_dict({k.removeprefix("backbone."): v
                           for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = model.get_feature(torch.from_numpy(x).movedim(-1, 1))
    assert len(got) == len(want) == LEVELS
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.movedim(1, -1).numpy(), np.asarray(b),
                                   atol=ATOL)


def _jax_critic(jcfg):
    """The JAX critic of the critic variant at fp64 (its random init)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        critic, params, key = jbuildmod.build_critic_from_cfg(
            jcfg, compute_dtype=jnp.float64)
    return critic, jax.tree.map(lambda a: np.asarray(a, np.float64),
                                params), key


def _port_critic(cfg, params):
    with pytest.warns(UserWarning, match="RANDOM"):
        critic, key = build_critic_from_cfg(cfg, device="cpu")
    critic.double().load_state_dict(from_jax_params(params), strict=True)
    return critic, key


def test_critic_outputs_match_jax():
    """implicit_pathol_outputs: the critic's sigmoid on the predicted and
    the target image at fp64; gradients reach the predicted image and
    never the critic; the target's score carries none."""
    jcfg = jbuildmod.process_args(variant_cfg(jload, "critic"))
    jcritic, jparams, jkey = _jax_critic(jcfg)
    cfg = variant_cfg(tload, "critic")
    cfg.tasks = list(jcfg.tasks)
    critic, key = _port_critic(cfg, jparams)
    assert key == jkey == "T1"
    assert not critic.training
    assert not any(p.requires_grad for p in critic.parameters())
    rng = np.random.default_rng(9)
    pred = rng.random((3, *SIZE, 1))
    tgt = rng.random((1, *SIZE, 1))
    want = jax.jit(lambda cp, o, t: jbuildmod.implicit_pathol_outputs(
        jcritic, cp, {"T1": o}, {"T1": t}, "T1"))(
        jparams, jnp.asarray(pred), jnp.asarray(tgt))
    t_pred = torch.from_numpy(pred).requires_grad_(True)
    got = implicit_pathol_outputs(critic, {"T1": t_pred},
                                  {"T1": torch.from_numpy(tgt)}, "T1")
    for k in ("implicit_pathol_pred", "implicit_pathol_orig"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), atol=ATOL, err_msg=k)
    assert not got["implicit_pathol_orig"].requires_grad
    got["implicit_pathol_pred"].sum().backward()
    assert t_pred.grad is not None and float(t_pred.grad.abs().sum()) > 0
    assert all(p.grad is None for p in critic.parameters())


# ------------------------------------------------------------------ steps

@pytest.fixture(scope="module")
def variants():
    """Per variant: the JAX cfg, model, params, criterion and critic, made
    once and shared by the step tests."""
    out = {}
    for name in VARIANTS:
        jcfg, jm, params = jax_variant(name)
        _, jw, jfn = jcriterion(jcfg)
        critic = _jax_critic(jcfg) if name == "critic" else None
        out[name] = dict(jcfg=jcfg, jm=jm, params=params, jw=jw, jfn=jfn,
                         critic=critic,
                         batch=variant_batch(0, jcfg.n_labels))
    return out


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_step_matches_jax(variants, name, accum):
    """One fp64 AdamW step of joint_age, sep and the critic-on flagship
    (critic frozen, its losses through the predicted image), monolithic
    and in 2 sample microbatches, against the JAX package's jitted
    make_train_step: metrics rtol 1e-10, params rel-L2 < 1e-9 per tensor;
    the critic's weights stay as they were."""
    v = variants[name]
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
        critic, key = _port_critic(cfg, v["critic"][1])
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


# ----------------------------------------------------- critic checkpoints

def test_critic_loads_checkpoints_and_refuses_a_partial_one(tmp_path):
    """supervised_pathol_seg_ckp_path: one .pth of the whole critic, or
    {feat: bare backbone, task: head} that together name every weight,
    load exactly; a path not on disk raises FileNotFoundError (as the
    JAX package does); parts that leave weights unloaded raise."""
    cfg = variant_cfg(tload, "critic", (16, 16, 16))
    cfg.tasks = ["T1"]
    with pytest.warns(UserWarning):
        ref, _ = build_critic_from_cfg(cfg, device="cpu", seed=11)
    sd = ref.state_dict()
    torch.save({"model": sd}, tmp_path / "critic.pth")
    torch.save({k.removeprefix("backbone."): v for k, v in sd.items()
                if k.startswith("backbone.")}, tmp_path / "feat.pth")
    torch.save({k: v for k, v in sd.items() if k.startswith("head.")},
               tmp_path / "task.pth")
    for ckp in (str(tmp_path / "critic.pth"),
                {"feat": str(tmp_path / "feat.pth"),
                 "task": str(tmp_path / "task.pth")}):
        cfg.supervised_pathol_seg_ckp_path = ckp
        critic, _ = build_critic_from_cfg(cfg, device="cpu")
        for k, t in critic.state_dict().items():
            assert torch.equal(t, sd[k]), k
    cfg.supervised_pathol_seg_ckp_path = {
        "feat": str(tmp_path / "feat.pth"),
        "task": str(tmp_path / "typo.pth")}
    with pytest.raises(FileNotFoundError, match="typo.pth"):
        build_critic_from_cfg(cfg, device="cpu")
    cfg.supervised_pathol_seg_ckp_path = {"feat": str(tmp_path / "feat.pth")}
    with pytest.raises(ValueError, match="unloaded"):
        build_critic_from_cfg(cfg, device="cpu")


def test_critic_needs_an_image_task_and_is_seeded():
    """No image task to score raises ValueError; the random init depends
    on the seed only (not on the caller's RNG state)."""
    cfg = AttrDict.from_nested({"losses": {"implicit_pathol": True},
                                "critic_f_maps": 8, "critic_num_levels": 2})
    cfg.tasks = ["segmentation"]
    with pytest.raises(ValueError, match="image task"):
        build_critic_from_cfg(cfg, device="cpu")
    cfg.tasks = ["segmentation", "FLAIR"]
    with pytest.warns(UserWarning):
        torch.manual_seed(1)
        a, key = build_critic_from_cfg(cfg, device="cpu")
        torch.manual_seed(2)
        b, _ = build_critic_from_cfg(cfg, device="cpu")
    assert key == "FLAIR"
    assert all(torch.equal(t, b.state_dict()[k])
               for k, t in a.state_dict().items())
