"""Two-stage inpainting (twostage.yaml with cfgs/generator/train/
twostage.yaml) against the JAX package on the CPU at fp64, the pair's
weights handed across by from_jax_params: the chained forward, one AdamW
step with train_stage0 true and false (a frozen stage 0 still takes the
decoupled weight decay), each monolithic and with sample_accum 2, the
pair's optax state carried across, and TwoStageInferencer; then the
port's own loop: train() with a bitwise resume of the pair, the training
CLI and the refusals the JAX package makes (a critic, cfg.condition and
--eval_only with two-stage). Models are cut to f_maps 8 and 3 levels."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brainfm_tpu.config import AttrDict as JAttrDict
from brainfm_tpu.config import load_config as jload
from brainfm_tpu.infer.api import TwoStageInferencer as JTwoStageInferencer
from brainfm_tpu.models.build import build_inpaint_model as jinpaint
from brainfm_tpu.models.build import twostage_forward as jtwostage_forward
from brainfm_tpu.models.criterion import make_criterion as jcriterion
from brainfm_tpu.train import step as jstep
from brainfm_tpu_torch.config import load_config as tload
from brainfm_tpu_torch.infer import TwoStageInferencer
from brainfm_tpu_torch.models import (TwoStage, build_inpaint_model,
                                      from_jax_params)
from brainfm_tpu_torch.models.criterion import make_criterion
from brainfm_tpu_torch.models.params_io import from_jax_opt_state
from brainfm_tpu_torch.scripts import train as train_script
from brainfm_tpu_torch.synth import SubjectBank
from brainfm_tpu_torch.train import checkpoint as ckpt
from brainfm_tpu_torch.train import loop
from brainfm_tpu_torch.train.step import (TrainState, build_optimizer,
                                          make_twostage_train_step)

from _torch_train_util import (jax_params_as_port, joint_cfg, port_params,
                               rel_l2, to_jax, to_torch)

ATOL = 1e-9
LOSS_RTOL = 1e-10
PARAM_REL_L2 = 1e-9
LR, WD = 1e-3, 1e-2
SIZE = (32, 32, 32)


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def pair_cfg(load, size=SIZE, num_levels=3):
    cfg = joint_cfg(load, f_maps=8, num_levels=num_levels, size=size,
                    gen="twostage", train="twostage")
    cfg.optimizer, cfg.lr, cfg.weight_decay = "adamw", LR, WD
    return cfg


def pair_batch(seed, n_labels, size=SIZE, S=2):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, n_labels, (1, 1, *size))
    return {"samples": {"input": rng.random((1, S, *size, 1))},
            "targets": {"T1": rng.random((1, 1, *size, 1)),
                        "segmentation": np.eye(n_labels)[lab],
                        "pathology": (rng.random((1, 1, *size, 1))
                                      < 0.2).astype(np.float64)}}


@pytest.fixture(scope="module")
def jpair():
    """The JAX package's pair at fp64, initialised as its train() does
    (stage 1 with cond=zeros_like(x)), its criterion and a batch."""
    jcfg, pm, tm = jinpaint(pair_cfg(jload), compute_dtype=jnp.float64)
    x = jnp.zeros((2, *SIZE, 1), jnp.float64)
    r1, r2 = jax.random.split(jax.random.PRNGKey(0))
    params = {"pathol": jax.jit(pm.init)(r1, x),
              "task": jax.jit(lambda r, a: tm.init(
                  r, a, cond=jnp.zeros_like(a)))(r2, x)}
    params = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    _, jw, jfn = jcriterion(jcfg)
    return dict(jcfg=jcfg, pm=pm, tm=tm, params=params, jw=jw, jfn=jfn,
                batch=pair_batch(0, jcfg.n_labels), steps={})


def port_pair(params, cfg=None):
    cfg, pair = build_inpaint_model(cfg or pair_cfg(tload), device="cpu")
    pair = pair.double()
    pair.load_state_dict(from_jax_params(params), strict=True)
    return cfg, pair


def test_twostage_forward_matches_jax(jpair):
    """The chained forward: stage 0's sigmoid mask, stage 1 on the masked
    input conditioned on it, both feature pyramids."""
    x = np.random.default_rng(1).random((2, *SIZE, 1))
    p = jpair["params"]
    want = jax.jit(lambda pp, tp, a: jtwostage_forward(
        jpair["pm"], jpair["tm"], pp, tp, a, jpair["jcfg"]))(
        p["pathol"], p["task"], jnp.asarray(x))
    _, pair = port_pair(p)
    assert isinstance(pair, TwoStage)
    assert pair.task.backbone.encoders[0].basic_module.SingleConv1 \
        .conv.weight.shape[1] == 2
    with torch.no_grad():
        got = pair(torch.from_numpy(x))
    assert set(got) == set(want)
    for k, v in want.items():
        for a, b in (zip(got[k], v) if isinstance(v, list) else
                     [(got[k], v)]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                       err_msg=k)


def _jax_step(jpair, train_stage0, accum):
    key = (train_stage0, accum)
    if key not in jpair["steps"]:
        jcfg = JAttrDict(dict(jpair["jcfg"]))
        jopt = jstep.build_optimizer(jcfg)
        jpair["steps"][key] = (jopt, jstep.make_twostage_train_step(
            jpair["pm"], jpair["tm"], jcfg, jpair["jw"], jpair["jfn"], jopt,
            train_stage0=train_stage0, donate=False, sample_accum=accum))
    return jpair["steps"][key]


def _assert_matches(jstate, jm_, state, pm):
    assert set(pm) == set(jm_)
    for k in jm_:
        np.testing.assert_allclose(float(pm[k]), float(jm_[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    want = jax_params_as_port(jstate.params)
    got = port_params(state.model)
    assert set(got) == set(want)
    for k in want:
        assert rel_l2(got[k], want[k]) < PARAM_REL_L2, k


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("train_stage0", [True, False])
def test_twostage_step_matches_jax(jpair, train_stage0, accum):
    """One fp64 AdamW step of the pair under one optimizer against the
    JAX package's make_twostage_train_step: metrics rtol 1e-10, every
    parameter of both stages rel-L2 < 1e-9. With train_stage0 false,
    stage 0 gets zero gradients and is still stepped: AdamW's decoupled
    decay moves it by exactly lr * wd * p, as under the JAX package's
    stop_gradient."""
    jopt, jfn = _jax_step(jpair, train_stage0, accum)
    p0 = jpair["params"]
    s0 = jstep.TrainState(p0, jopt.init(p0), jnp.zeros((), jnp.int32))
    js, jm_ = jfn(s0, to_jax(jpair["batch"]), LR, WD)

    cfg, pair = port_pair(p0)
    _, w, loss_fn = make_criterion(cfg)
    opt = build_optimizer(cfg, pair.parameters())
    step = make_twostage_train_step(pair, cfg, w, loss_fn, opt,
                                    train_stage0=train_stage0,
                                    sample_accum=accum, amp=False)
    state, pm = step(TrainState(pair, opt, 0), to_torch(jpair["batch"]), LR,
                     WD)
    assert state.step == 1 and float(pm["skipped"]) == 0.0
    assert {"loss_pathol_ce", "loss_T1"} <= set(pm)
    _assert_matches(js, jm_, state, pm)
    before = jax_params_as_port(p0)
    after = port_params(pair)
    if not train_stage0:
        for k in after:
            if k.startswith("pathol."):
                np.testing.assert_allclose(after[k], before[k] * (1 - LR * WD),
                                           rtol=1e-12, atol=0, err_msg=k)
    assert any(not np.array_equal(after[k], before[k]) for k in after
               if k.startswith("task."))


def test_pair_opt_state_carries_across(jpair):
    """JAX two steps == JAX one step, then the pair's params and optax
    state handed to the port (from_jax_params, from_jax_opt_state in the
    pair's parameter order), then one port step."""
    jopt, jfn = _jax_step(jpair, True, 1)
    p0 = jpair["params"]
    s0 = jstep.TrainState(p0, jopt.init(p0), jnp.zeros((), jnp.int32))
    batch = to_jax(jpair["batch"])
    s1, _ = jfn(s0, batch, LR, WD)
    s2, m2 = jfn(s1, batch, LR, WD)
    cfg, pair = port_pair(jax.tree.map(np.asarray, s1.params))
    opt = build_optimizer(cfg, pair.parameters())
    opt.load_state_dict(from_jax_opt_state(
        jax.tree.map(np.asarray, s1.opt_state), pair, opt))
    first = next(iter(opt.state_dict()["state"].values()))
    assert float(first["step"]) == 1.0
    _, w, loss_fn = make_criterion(cfg)
    step = make_twostage_train_step(pair, cfg, w, loss_fn, opt, amp=False)
    state, pm = step(TrainState(pair, opt, 0), to_torch(jpair["batch"]), LR,
                     WD)
    _assert_matches(s2, m2, state, pm)


def test_twostage_inferencer_matches_jax(jpair):
    """TwoStageInferencer.evaluate_image against the JAX class, both
    stages' weights handed across: every output (the kept mask, the
    processed task outputs, the label map of postprocess) and the two
    last feature levels of feature_only."""
    jcfg = pair_cfg(jload)
    jinf = JTwoStageInferencer(jcfg, compute_dtype=jnp.float64)
    vol = np.random.default_rng(3).random(SIZE)
    want = jinf.evaluate_image(vol)
    wfp, wft = jinf.evaluate_image(vol, feature_only=True)
    inf = TwoStageInferencer(pair_cfg(tload), compute_dtype=torch.float64,
                             device="cpu")
    inf.model.load_state_dict(from_jax_params(
        {"pathol": jax.tree.map(np.asarray, jinf.pathol_params),
         "task": jax.tree.map(np.asarray, jinf.task_params)}), strict=True)
    got = inf.evaluate_image(vol)
    assert set(got) == set(want)
    assert "label" in got and float(got["pathology"].max()) <= 1.0
    for k, v in want.items():
        for a, b in (zip(got[k], v) if isinstance(v, list) else
                     [(got[k], v)]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                       err_msg=k)
    gfp, gft = inf.evaluate_image(vol, feature_only=True)
    np.testing.assert_allclose(gfp.numpy(), np.asarray(wfp), atol=ATOL)
    np.testing.assert_allclose(gft.numpy(), np.asarray(wft), atol=ATOL)


# ----------------------------------------------------- the port's own loop

TRAIN_SIZE = (16, 16, 16)


def _small_pair_cfg(n_epochs):
    """The pair at 16^3, 2 levels. The weight decay is constant (its
    cosine schedule spans n_epochs), so a 1-epoch run is the first epoch
    of a 2-epoch one."""
    cfg = pair_cfg(tload, size=TRAIN_SIZE, num_levels=2)
    cfg.n_epochs, cfg.remat = n_epochs, False
    cfg.weight_decay_end = cfg.weight_decay
    return cfg


def _bank():
    bank = SubjectBank((24, 24, 24))
    bank.add_debug_subject(seed=0, extent=(20, 22, 20))
    bank.add_debug_subject(seed=1, extent=(22, 20, 21))
    return bank


def _train_pair(out_dir, n_epochs, resume=None):
    torch.manual_seed(0)
    cfg, pair = build_inpaint_model(_small_pair_cfg(n_epochs), device="cpu")
    _, w, fn = make_criterion(cfg)
    return loop.train(cfg, None, w, fn, _bank(), str(out_dir),
                      itr_per_epoch=2, n_val_items=1, log_itr=1,
                      resume=resume, twostage_models=pair)


def _state_bytes(state):
    out = {f"p.{k}": v.numpy().tobytes()
           for k, v in state.model.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            out[f"o.{i}.{k}"] = v.numpy().tobytes()
    return out


def test_train_pair_resumes_bitwise_and_serves(tmp_path):
    """train(twostage_models=) over 2 epochs: both stages' losses in the
    log, validation, epoch and best checkpoints of the pair. A run
    stopped after epoch 0 and resumed from its checkpoint ends bitwise
    where the uninterrupted one ends. TwoStageInferencer serves the run's
    ckp/ root."""
    full = _train_pair(tmp_path / "full", 2)
    lines = [json.loads(s) for s in open(tmp_path / "full" / "log.txt")]
    assert [s["epoch"] for s in lines] == [0, 1]
    for s in lines:
        assert np.isfinite(s["train_loss_total"]) and s["train_skipped"] == 0
        assert np.isfinite(s["val_loss_total"])
        assert {"train_loss_pathol_ce", "train_loss_T1"} <= set(s)
    assert full.step == 4 and isinstance(full.model, TwoStage)
    _train_pair(tmp_path / "part", 1)
    resumed = _train_pair(tmp_path / "part", 2, resume=str(
        tmp_path / "part" / "ckp" / "ckpt_000002"))
    assert resumed.step == 4
    assert _state_bytes(resumed) == _state_bytes(full)

    root = str(tmp_path / "full" / "ckp")
    cfg = _small_pair_cfg(1)
    inf = TwoStageInferencer(cfg, pathol_ckpt=root, task_ckpt=root,
                             device="cpu")
    for k, v in inf.model.state_dict().items():
        assert torch.equal(v, full.model.state_dict()[k]), k
    out = inf.evaluate_image(np.random.default_rng(0).random(TRAIN_SIZE))
    assert out["pathology"].shape == (1, *TRAIN_SIZE, 1)
    assert out["label"].dtype == torch.int32
    sd = full.model.pathol.state_dict()
    torch.save(sd, tmp_path / "pathol.pth")
    only = TwoStageInferencer(cfg, pathol_ckpt=str(tmp_path / "pathol.pth"),
                              device="cpu")
    assert all(torch.equal(v, sd[k])
               for k, v in only.model.pathol.state_dict().items())
    with pytest.raises(FileNotFoundError):
        TwoStageInferencer(cfg, task_ckpt=str(tmp_path / "none"),
                           device="cpu")


@pytest.mark.parametrize("over,match", [
    ({"losses": {"implicit_pathol": True}}, "implicit_pathol"),
    ({"condition": "mask"}, "condition")])
def test_train_refuses_a_critic_or_condition_with_twostage(tmp_path, over,
                                                           match):
    """As the JAX package: the critic and cfg.condition raise ValueError
    with two-stage training."""
    cfg = _small_pair_cfg(1)
    for k, v in over.items():
        if isinstance(v, dict):
            cfg[k].update(v)
        else:
            cfg[k] = v
    cfg, pair = build_inpaint_model(cfg, device="cpu")
    _, w, fn = make_criterion(cfg)
    with pytest.raises(ValueError, match=match):
        loop.train(cfg, None, w, fn, _bank(), str(tmp_path),
                   twostage_models=pair)


def test_cli_trains_twostage_and_refuses_eval_only(tmp_path, capsys,
                                                   monkeypatch):
    """The CLI on an 'a+b' backbone trains the pair from the debug
    datasets' stream; --eval_only with it is an error, as in the JAX
    script."""
    import functools

    from brainfm_tpu_torch.synth import datasets

    monkeypatch.setattr(train_script, "build_datasets", functools.partial(
        datasets.build_datasets, bank_shape=(24, 24, 24),
        debug_extent=(22, 22, 22)))
    tr, gen = tmp_path / "tr.yaml", tmp_path / "gen.yaml"
    tr.write_text("job_name: cli\nbackbone: unet3d+unet3d\nf_maps: 8\n"
                  "num_levels: 2\ntask_f_maps: [8]\nremat: False\n")
    gen.write_text("generator:\n  size: [16, 16, 16]\n  all_samples: 2\n"
                   "task: {T1: True, pathology: True, segmentation: True}\n"
                   "dataset_names: [HCP, ATLAS]\n")
    args = ["--train_cfg", str(tr), "--gen_cfg", str(gen), "--device", "cpu",
            "--debug", "--no_amp", "--out_dir", str(tmp_path / "run")]
    assert train_script.main(args) == 0
    assert "final step 2" in capsys.readouterr().out
    line = json.loads(open(tmp_path / "run" / "log.txt").readline())
    assert np.isfinite(line["train_loss_pathol_ce"])
    assert os.path.isfile(tmp_path / "run" / "ckp" / "ckpt_000002" /
                          ckpt.MODEL_FILE)
    with pytest.raises(SystemExit):
        train_script.main([*args, "--eval_only", "--resume",
                           str(tmp_path / "run" / "ckp" / "ckpt_000002")])
    assert "two-stage" in capsys.readouterr().err
