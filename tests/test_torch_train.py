"""The port's training step against the JAX package's on the CPU at fp64:
loss primitives, every criterion loss name, the schedules, one train step
under each optimizer and clip mode, sample accumulation, the non-finite
skip, rematerialization and the optimizer state carried across from optax.

The JAX step is `value_and_grad(loss_and_metrics)` then `_finite_update`
(brainfm_tpu/train/step.py). Its jit is compiled once per optimizer, so
the cases share one jitted value_and_grad of the same loss and call the
JAX package's own `_finite_update` per optimizer;
`test_decomposed_jax_step_is_the_jax_step` holds that decomposition to
the jitted `make_train_step`. Model: the joint config at f_maps 8, two
levels, 8^3, S=4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brainfm_tpu.config import AttrDict as JAttrDict
from brainfm_tpu.models import losses as jlosses
from brainfm_tpu.models.build import apply_processors as japply
from brainfm_tpu.models.criterion import make_criterion as jcriterion
from brainfm_tpu.models.criterion import weighted_total as jweighted
from brainfm_tpu.train import schedules as jsched
from brainfm_tpu.train import step as jstep
from brainfm_tpu_torch.config import AttrDict
from brainfm_tpu_torch.config import load_config as tload
from brainfm_tpu_torch.models import build_model, losses
from brainfm_tpu_torch.models.build import (apply_processors,
                                            build_critic_from_cfg)
from brainfm_tpu_torch.models.criterion import make_criterion, weighted_total
from brainfm_tpu_torch.models.params_io import from_jax_opt_state
from brainfm_tpu_torch.models.unet3d import remat_mode
from brainfm_tpu_torch.train import schedules
from brainfm_tpu_torch.train.step import (TrainState, build_optimizer,
                                          make_train_step)

from _torch_train_util import (jax_model, jax_params_as_port, joint_cfg,
                               np_batch, port_model, port_params, rel_l2,
                               to_jax, to_torch)

# fp64 on both sides; only summation order differs (and GroupNorm's
# variance formula, ~1e-11 in the model's outputs)
LOSS_RTOL = 1e-10
PARAM_REL_L2 = 1e-9
LR, WD = 1e-3, 1e-2


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


# ---------------------------------------------------------------- losses

def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape)


def _primitive_cases():
    x, y, w = _rand(1, 2, 6, 5, 7, 3), _rand(2, 2, 6, 5, 7, 3), \
        np.abs(_rand(3, 2, 6, 5, 7, 3))
    s = 0.3 * _rand(4, 2, 6, 5, 7, 3)
    return {
        "l1": ("l1_loss", (x, y, w)), "l2": ("l2_loss", (x, y, w)),
        "gaussian": ("gaussian_loss", (x, s, y, w)),
        "laplace": ("laplace_loss", (x, s, y, w)),
        "gradient_l1": ("gradient_loss", (x, y, w)),
        "gradient_l2": ("gradient_loss", (x, y, w, "l2")),
        "smoothness_l2": ("smoothness_loss", (x,)),
        "smoothness_l1": ("smoothness_loss", (x, "l1")),
        "hessian_l2": ("hessian_loss", (x,)),
        "hessian_l1": ("hessian_loss", (x, "l1")),
    }


@pytest.mark.parametrize("case", sorted(_primitive_cases()))
def test_loss_primitive_matches_jax(case):
    """Values and input gradients, rtol 1e-10."""
    name, args = _primitive_cases()[case]
    arrays = [i for i, a in enumerate(args) if isinstance(a, np.ndarray)]

    def jf(*xs):
        a = list(args)
        for i, v in zip(arrays, xs):
            a[i] = v
        return getattr(jlosses, name)(*a)

    want, jgrads = jax.value_and_grad(jf, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(args[i]) for i in arrays])
    ts = [torch.tensor(args[i], requires_grad=True) for i in arrays]
    a = list(args)
    for i, t in zip(arrays, ts):
        a[i] = t
    got = getattr(losses, name)(*a)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    for t, g in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=LOSS_RTOL, atol=1e-12)


def test_fwd_diff_and_hessian_partial_reuse():
    """_fwd_diff zeroes the last slice of each spatial axis, bitwise as
    JAX does. hessian_loss takes ddxy, ddxz and ddyz from the later
    difference calls (the reference's rebinding); forward differences
    with zeroed last slices commute, so the rebound partials equal the
    first ones in value and the rebinding shows only in rounding."""
    x = _rand(5, 6, 5, 7, 2)
    t = torch.from_numpy(x)
    for a, b in zip(losses._fwd_diff(t), jlosses._fwd_diff(jnp.asarray(x))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    dx, dy, _ = losses._fwd_diff(t)
    np.testing.assert_allclose(losses._fwd_diff(dx)[1].numpy(),
                               losses._fwd_diff(dy)[0].numpy(), atol=1e-12)
    got = losses.hessian_loss(t)
    np.testing.assert_allclose(float(got),
                               float(jlosses.hessian_loss(jnp.asarray(x))),
                               rtol=LOSS_RTOL)


# ------------------------------------------------------------- criterion

N_LAB = 7
LABELS = [0, 14, 15, 16, 24, 77, 85]


def _crit_cfg(attr, tasks, **losses_over):
    lo = {"image_grad": True, "registration_grad": True,
          "registration_smooth": True, "registration_hessian": True,
          "bias_field_log_type": "l2", "uncertainty": None,
          "implicit_pathol": False}
    lo.update(losses_over)
    w = {k: 1.0 + 0.1 * i for i, k in enumerate(
        ("seg_ce", "seg_dice", "pathol_ce", "pathol_dice",
         "implicit_pathol_ce", "implicit_pathol_dice", "image", "image_grad",
         "bias_field_log", "contrastive", "age", "surface", "distance",
         "registration", "registration_grad", "registration_smooth",
         "registration_hessian"))}
    return attr.from_nested({
        "tasks": list(tasks), "n_labels": N_LAB,
        "label_list_segmentation_with_csf": LABELS,
        "relative_weight_lesions": 3.0, "losses": lo, "weights": w,
        "contrastive_temperatures": {"alpha": 0.7, "beta": 1.3,
                                     "gamma": 2.1}})


def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _crit_inputs(case, S=2, size=(5, 6, 4)):
    """(tasks, losses overrides, outputs, targets, samples), numpy."""
    rng = np.random.default_rng(len(case))

    def vol(c, lead=S):
        return rng.standard_normal((lead, *size, c))

    def prob(c, lead=S):
        return rng.uniform(0.05, 0.95, (lead, *size, c))

    seg_t = np.eye(N_LAB)[rng.integers(0, N_LAB, (1, *size))]
    out = {"T1": vol(1), "segmentation": _softmax(vol(N_LAB)),
           "distance": vol(4), "registration": vol(3),
           "bias_field_log": vol(1)}
    tgt = {"T1": vol(1, 1), "segmentation": seg_t, "distance": vol(4, 1),
           "registration": vol(3, 1)}
    smp = {"bias_field_log": vol(1)}
    joint = ("T1", "T2", "FLAIR", "CT", "segmentation", "distance",
             "bias_field", "registration")
    if case == "joint":   # T2/FLAIR/CT have no output or target: skipped
        tgt["T1_DM"] = (rng.random((1, *size, 1)) < 0.3).astype(float)
        return joint, {}, out, tgt, smp
    if case in ("gaussian", "laplace"):
        out["T1_sigma"] = 0.3 * vol(1)
        return joint, {"uncertainty": case, "bias_field_log_type": "l1"}, \
            out, tgt, smp
    if case == "pathology":
        out.update(pathology=prob(1), implicit_pathol_pred=prob(1),
                   implicit_pathol_orig=prob(1))
        tgt["pathology"] = (rng.random((1, *size, 1)) < 0.4).astype(float)
        return ("T1", "segmentation", "pathology"), \
            {"implicit_pathol": True}, out, tgt, smp
    if case == "skips":   # every optional input absent: each name skipped
        return ("T1", "pathology", "bias_field"), \
            {"implicit_pathol": True}, {"T1": out["T1"]}, \
            {"T1": tgt["T1"]}, {}
    if case == "sr_age_surface":
        out.update(high_res_residual=vol(1), age=rng.random(S),
                   surface=vol(2))
        tgt.update(age=rng.random(1), surface=vol(2, 1))
        smp["high_res_residual"] = vol(1)
        return ("super_resolution", "age", "surface"), {}, out, tgt, smp
    if case == "contrastive":
        f = vol(6)
        out["feat"] = [vol(3), f / np.linalg.norm(f, axis=-1, keepdims=True)]
        return ("contrastive", "T1"), {}, out, tgt, smp
    raise KeyError(case)


CRIT_CASES = ("joint", "gaussian", "laplace", "pathology", "skips",
              "sr_age_surface", "contrastive")


@pytest.mark.parametrize("case", CRIT_CASES)
def test_criterion_matches_jax(case):
    """Every loss name the case's config adds (and its `continue` skips),
    the weight dict, each loss value and the weighted total's gradient
    with respect to every output: rtol 1e-10."""
    tasks, lo, out, tgt, smp = _crit_inputs(case)
    jnames, jw, jfn = jcriterion(_crit_cfg(JAttrDict, tasks, **lo))
    names, w, fn = make_criterion(_crit_cfg(AttrDict, tasks, **lo))
    assert names == jnames and w == jw

    def jtotal(o):
        ls = jfn(o, {k: jnp.asarray(v) for k, v in tgt.items()},
                 {k: jnp.asarray(v) for k, v in smp.items()})
        return jweighted(ls, jw), ls

    jo = {k: [jnp.asarray(f) for f in v] if k == "feat" else jnp.asarray(v)
          for k, v in out.items()}
    (jt, jls), jg = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(jo)
    to = {k: [torch.tensor(f, requires_grad=True) for f in v]
          if k == "feat" else torch.tensor(v, requires_grad=True)
          for k, v in out.items()}
    ls = fn(to, {k: torch.from_numpy(v) for k, v in tgt.items()},
            {k: torch.from_numpy(v) for k, v in smp.items()})
    assert set(ls) == set(jls)
    if case == "skips":
        assert set(ls) == {"loss_T1", "loss_T1_grad"}
    for k in jls:
        np.testing.assert_allclose(float(ls[k]), float(jls[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    total = sum(w[k] * ls[k] for k in w if k in ls)
    np.testing.assert_allclose(float(total), float(jt), rtol=LOSS_RTOL)
    total.backward()
    for k, v in to.items():
        pairs = zip(v, jg[k]) if k == "feat" else [(v, jg[k])]
        for a, b in pairs:
            got = np.zeros(a.shape) if a.grad is None else a.grad.numpy()
            np.testing.assert_allclose(got, np.asarray(b), rtol=LOSS_RTOL,
                                       atol=1e-13, err_msg=k)


# ------------------------------------------------------------- schedules

def _sched_cfg(attr, kind, warmup):
    return attr.from_nested({
        "lr_scheduler": kind, "lr": 1e-4, "min_lr": 1e-6, "n_epochs": 7,
        "warmup_epochs": warmup, "lr_drops": [3, 5], "lr_drop_multi": 0.3,
        "weight_decay": 0.05, "weight_decay_end": 0.01})


@pytest.mark.parametrize("kind", ["multistep", "cosine"])
@pytest.mark.parametrize("warmup", [0, 1, 2])
def test_schedules_match_jax_exactly(kind, warmup):
    for ipe in (1, 5):
        got = schedules.build_schedules(_sched_cfg(AttrDict, kind, warmup),
                                        ipe)
        want = jsched.build_schedules(_sched_cfg(JAttrDict, kind, warmup),
                                      ipe)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        schedules.multistep_schedule(2.0, [1], 3, 4, warmup, 0.5, 0.2),
        jsched.multistep_schedule(2.0, [1], 3, 4, warmup, 0.5, 0.2))
    np.testing.assert_array_equal(
        schedules.cosine_schedule(2.0, 0.1, 3, 4, warmup, 0.5),
        jsched.cosine_schedule(2.0, 0.1, 3, 4, warmup, 0.5))


# ------------------------------------------------------------ train step

@pytest.fixture(scope="module")
def setup():
    """The JAX model, its params, a batch (and one with a NaN voxel), the
    jitted JAX value_and_grad of the step's loss, and the grads at the
    initial params."""
    jcfg, jm, params = jax_model()
    _, jw, jfn = jcriterion(jcfg)
    batch = np_batch(0, jcfg.n_labels)
    nan_batch = np_batch(0, jcfg.n_labels)
    nan_batch["samples"]["input"][0, 1, 3, 4, 5, 0] = np.nan

    def loss_and_metrics(p, b):   # brainfm_tpu/train/step.py, cond None
        def per_item(s, t):
            return jfn(japply(jm.apply(p, s["input"]), jcfg), t, s)

        ls = jax.vmap(per_item)(b["samples"], b["targets"])
        ls = {k: jnp.mean(v) for k, v in ls.items()}
        return jweighted(ls, jw), ls

    vg = jax.jit(jax.value_and_grad(loss_and_metrics, has_aux=True))
    return dict(jcfg=jcfg, jm=jm, params=params, jw=jw, jfn=jfn,
                batch=batch, nan_batch=nan_batch, vg=vg, opts={},
                out0=vg(params, to_jax(batch)))


def _clip_for(grads, mode):
    """A clip that binds: half the median tensor norm (per_param) or half
    the global norm."""
    norms = [float(jnp.linalg.norm(g)) for g in jax.tree.leaves(grads)]
    if mode == "per_param":
        return 0.5 * float(np.median(norms))
    if mode == "global":
        return 0.5 * float(np.sqrt(np.sum(np.square(norms))))
    return 0.0


def _jax_opt(setup, opt, clip_mode):
    """(cfg overrides, optax optimizer, jitted _finite_update at LR, WD)
    of one optimizer and clip mode, made once per module so the tests of
    one setting share its compile."""
    key = (opt, clip_mode)
    if key not in setup["opts"]:
        over = {"optimizer": opt, "lr": LR, "weight_decay": WD,
                "clip_max_norm": _clip_for(setup["out0"][1], clip_mode)}
        if clip_mode:
            over["clip_mode"] = clip_mode
        jcfg = JAttrDict(dict(setup["jcfg"]))
        jcfg.update(over)
        jopt = jstep.build_optimizer(jcfg)
        update = jax.jit(lambda s, t, ls, g: jstep._finite_update(
            s, jopt, t, ls, g, LR, WD))
        setup["opts"][key] = (over, jopt, update)
    return setup["opts"][key]


def _jax_step(setup, opt, clip_mode, state=None, batch=None):
    """One JAX train step: the jitted value_and_grad at the state's params
    (default: the initial params, fresh optimizer state), then the JAX
    package's _finite_update."""
    _, jopt, update = _jax_opt(setup, opt, clip_mode)
    if state is None:
        state = jstep.TrainState(setup["params"], jopt.init(setup["params"]),
                                 jnp.zeros((), jnp.int32))
        out = setup["out0"] if batch is None else None
    else:
        out = None
    (t, ls), g = out or setup["vg"](state.params,
                                    to_jax(batch or setup["batch"]))
    return update(state, t, ls, g)


def _port_state(setup, over, params=None, opt_state=None):
    cfg, model = port_model(setup["params"] if params is None else params,
                            cfg_over=over)
    opt = build_optimizer(cfg, model.parameters())
    if opt_state is not None:
        opt.load_state_dict(from_jax_opt_state(opt_state, model, opt))
    _, w, loss_fn = make_criterion(cfg)
    step = make_train_step(model, cfg, w, loss_fn, opt, amp=False)
    return TrainState(model, opt, 0), step


def _assert_step_matches(jout, pstate, pm):
    jstate, jm_ = jout
    assert set(pm) == set(jm_)
    for k in jm_:
        np.testing.assert_allclose(float(pm[k]), float(jm_[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    want = jax_params_as_port(jstate.params)
    got = port_params(pstate.model)
    for k in want:
        assert rel_l2(got[k], want[k]) < PARAM_REL_L2, k


@pytest.mark.parametrize("clip_mode", [None, "per_param", "global"])
@pytest.mark.parametrize("opt", ["adam", "adamw", "sgd", "lars"])
def test_train_step_matches_jax(setup, opt, clip_mode):
    """One step from the same params and batch: metrics rtol 1e-10,
    updated params rel-L2 < 1e-9 per tensor, and the update itself
    (new - old) within 1e-6 relative L2."""
    jout = _jax_step(setup, opt, clip_mode)
    state, step = _port_state(setup, _jax_opt(setup, opt, clip_mode)[0])
    state, pm = step(state, to_torch(setup["batch"]), LR, WD)
    assert state.step == 1 and float(pm["skipped"]) == 0.0
    _assert_step_matches(jout, state, pm)
    p0 = jax_params_as_port(setup["params"])
    want = jax_params_as_port(jout[0].params)
    got = port_params(state.model)
    upd = rel_l2(np.concatenate([(got[k] - p0[k]).ravel() for k in p0]),
                 np.concatenate([(want[k] - p0[k]).ravel() for k in p0]))
    assert upd < 1e-6


def test_decomposed_jax_step_is_the_jax_step(setup):
    """The tests' JAX step (jitted value_and_grad + _finite_update) equals
    the JAX package's jitted make_train_step."""
    over, opt, _ = _jax_opt(setup, "adamw", "per_param")
    jstate, jmet = _jax_step(setup, "adamw", "per_param")
    jcfg = JAttrDict(dict(setup["jcfg"]))
    jcfg.update(over)
    step = jstep.make_train_step(setup["jm"], jcfg, setup["jw"],
                                 setup["jfn"], opt, donate=False)
    s0 = jstep.TrainState(setup["params"], opt.init(setup["params"]),
                          jnp.zeros((), jnp.int32))
    s1, m1 = step(s0, to_jax(setup["batch"]), LR, WD)
    for k in m1:
        np.testing.assert_allclose(float(jmet[k]), float(m1[k]), rtol=1e-12)
    a, b = jax_params_as_port(jstate.params), jax_params_as_port(s1.params)
    for k in a:
        assert rel_l2(a[k], b[k]) < 1e-12, k


def test_sample_accum_matches_monolithic_and_jax(setup):
    """sample_accum=2 over S=4 equals the port's monolithic step and the
    JAX package's step_accum (jitted make_train_step(sample_accum=2));
    a k that does not divide S fails its assertion."""
    over, jopt, _ = _jax_opt(setup, "adamw", None)
    jcfg = JAttrDict(dict(setup["jcfg"]))
    jcfg.update(over)
    jaccum = jstep.make_train_step(setup["jm"], jcfg, setup["jw"],
                                   setup["jfn"], jopt, donate=False,
                                   sample_accum=2)
    s0 = jstep.TrainState(setup["params"], jopt.init(setup["params"]),
                          jnp.zeros((), jnp.int32))
    jout = jaccum(s0, to_jax(setup["batch"]), LR, WD)

    mono, mono_step = _port_state(setup, over)
    mono, mm = mono_step(mono, to_torch(setup["batch"]), LR, WD)
    cfg, model = port_model(setup["params"], cfg_over=over)
    opt = build_optimizer(cfg, model.parameters())
    _, w, loss_fn = make_criterion(cfg)
    accum = make_train_step(model, cfg, w, loss_fn, opt, sample_accum=2,
                            amp=False)
    state, am = accum(TrainState(model, opt, 0), to_torch(setup["batch"]),
                      LR, WD)
    _assert_step_matches(jout, state, am)
    for k in mm:
        np.testing.assert_allclose(float(am[k]), float(mm[k]), rtol=1e-12)
    a, b = port_params(state.model), port_params(mono.model)
    for k in a:
        assert rel_l2(a[k], b[k]) < PARAM_REL_L2, k
    bad = make_train_step(model, cfg, w, loss_fn, opt, sample_accum=3,
                          amp=False)
    with pytest.raises(AssertionError, match="must divide"):
        bad(state, to_torch(setup["batch"]), LR, WD)


def _opt_tensors(opt):
    return {f"{i}.{k}": v.clone() for i, st in opt.state_dict()["state"]
            .items() for k, v in st.items() if torch.is_tensor(v)}


@pytest.mark.parametrize("opt", ["adamw", "sgd", "lars"])
def test_nan_batch_skips_bitwise(setup, opt):
    """After one good step (so the optimizer holds moments and counts), a
    batch with one NaN voxel leaves the params, every optimizer state
    tensor and TrainState.step bitwise as they were; every loss reads NaN
    and `skipped` 1, as the JAX package reports them. (The JAX package
    advances TrainState.step on a skipped step too; the port counts
    applied updates only.)"""
    over = _jax_opt(setup, opt, "per_param")[0]
    jstate, jmet = _jax_step(setup, opt, "per_param",
                             batch=setup["nan_batch"])
    assert float(jmet["skipped"]) == 1.0
    assert all(np.isnan(float(v)) for k, v in jmet.items() if k != "skipped")
    for a, b in zip(jax.tree.leaves(jstate.params),
                    jax.tree.leaves(setup["params"])):
        np.testing.assert_array_equal(np.asarray(a), b)

    state, step = _port_state(setup, over)
    state, _ = step(state, to_torch(setup["batch"]), LR, WD)
    params, opt_t, n = port_params(state.model), _opt_tensors(
        state.optimizer), state.step
    state, pm = step(state, to_torch(setup["nan_batch"]), LR, WD)
    assert set(pm) == set(jmet)
    assert float(pm["skipped"]) == 1.0
    assert all(np.isnan(float(v)) for k, v in pm.items() if k != "skipped")
    assert state.step == n == 1
    for k, v in port_params(state.model).items():
        assert v.tobytes() == params[k].tobytes(), k
    after = _opt_tensors(state.optimizer)
    assert after.keys() == opt_t.keys() and after
    for k in after:
        assert torch.equal(after[k], opt_t[k]), k


@pytest.mark.parametrize("remat", [True, "full", "save_convs"])
def test_remat_gives_the_same_gradients(setup, remat):
    """Rematerialized blocks recompute the same fp64 ops: every gradient
    equals the plain backward's to 1e-12 relative L2."""
    grads = {}
    b = to_torch(setup["batch"])
    for r in (False, remat):
        cfg, model = port_model(setup["params"], cfg_over={"remat": r})
        _, w, loss_fn = make_criterion(cfg)
        ls = loss_fn(apply_processors(model(b["samples"]["input"][0]), cfg),
                     {k: v[0] for k, v in b["targets"].items()},
                     {k: v[0] for k, v in b["samples"].items()})
        weighted_total(ls, w).backward()
        grads[r] = {n: p.grad.numpy().copy()
                    for n, p in model.named_parameters()}
    for k in grads[False]:
        assert rel_l2(grads[remat][k], grads[False][k]) < 1e-12, k


def test_remat_modes_and_bad_values():
    assert remat_mode(False) is False and remat_mode(None) is False
    assert remat_mode(True) == remat_mode("full") == "full"
    assert remat_mode("save_convs") == "save_convs"
    with pytest.raises(ValueError, match="remat"):
        remat_mode("everything")
    cfg = joint_cfg(tload)
    cfg.remat = "bogus"
    with pytest.raises(ValueError, match="remat"):
        build_model(cfg, device="cpu")


@pytest.mark.parametrize("opt", ["adam", "adamw", "sgd", "lars"])
def test_opt_state_carries_across(setup, opt):
    """JAX two steps == JAX one step, then its params and optax state
    handed to the port (from_jax_params, from_jax_opt_state), then one
    port step: params rel-L2 < 1e-9 per tensor, metrics rtol 1e-10."""
    over = _jax_opt(setup, opt, None)[0]
    s1, _ = _jax_step(setup, opt, None)
    s2, m2 = _jax_step(setup, opt, None, state=s1)

    p1 = jax.tree.map(np.asarray, s1.params)
    state, step = _port_state(setup, over, params=p1,
                              opt_state=jax.tree.map(np.asarray,
                                                     s1.opt_state))
    state, pm = step(state, to_torch(setup["batch"]), LR, WD)
    _assert_step_matches((s2, m2), state, pm)


# ------------------------------------------------ optimizer, clip, critic

def test_optimizer_and_clip_options():
    from brainfm_tpu_torch.train.step import (LARS, _clip_fn,
                                              clip_by_global_norm,
                                              clip_per_parameter)
    p = [torch.nn.Parameter(torch.ones(3))]
    for name, cls in (("adam", torch.optim.Adam), ("adamw", torch.optim.AdamW),
                      ("sgd", torch.optim.SGD), ("lars", LARS)):
        o = build_optimizer(AttrDict(optimizer=name, lr=0.1), p)
        assert type(o) is cls
    assert build_optimizer(AttrDict(optimizer="sgd", lr=0.1),
                           p).param_groups[0]["momentum"] == 0.9
    with pytest.raises(ValueError, match="unknown optimizer"):
        build_optimizer(AttrDict(optimizer="rmsprop"), p)
    with pytest.raises(ValueError, match="clip_mode"):
        _clip_fn(AttrDict(clip_max_norm=1.0, clip_mode="norm"))
    assert _clip_fn(AttrDict(clip_max_norm=0.0)) is None
    g = [torch.full((4,), 3.0), torch.full((4,), 0.1)]
    clip_per_parameter(g, 1.0)
    np.testing.assert_allclose(float(torch.linalg.norm(g[0])),
                               6.0 / (6.0 + 1e-6), rtol=1e-6)
    np.testing.assert_allclose(g[1].numpy(), 0.1, rtol=1e-7)
    g = [torch.full((4,), 3.0), torch.full((4,), 4.0)]
    clip_by_global_norm(g, 5.0)
    np.testing.assert_allclose(float(torch.sqrt(sum((x ** 2).sum()
                                                    for x in g))), 5.0,
                               rtol=1e-6)


def test_critic_flag_is_refused_not_ignored():
    """Off, the flag builds nothing; on, it builds the frozen critic (a
    random init announced by a warning), where it used to raise."""
    cfg = AttrDict.from_nested({"losses": {"implicit_pathol": False},
                                "critic_f_maps": 8, "critic_num_levels": 2})
    assert build_critic_from_cfg(cfg) == (None, None)
    cfg.losses.implicit_pathol = True
    cfg.tasks = ["T1"]
    with pytest.warns(UserWarning, match="RANDOM"):
        critic, key = build_critic_from_cfg(cfg, device="cpu")
    assert key == "T1" and not critic.training
    assert not any(p.requires_grad for p in critic.parameters())
