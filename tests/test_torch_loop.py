"""The port's training loop on the CPU: the eval step, conditioning, batch
stacking and the samplers against the JAX package's; then the port's own
loop: checkpoints in its format, train() with a resume that ends bitwise
where an uninterrupted run ends, train() on the dataset stream, the
training CLI (from a data root in the DATASET_SETUPS layout, and
--eval_only), the two-stage pair and the critic through train() and the
CLI, and the checks of the mesh and FSDP arguments."""

import functools
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax

from brainfm_tpu.models.criterion import make_criterion as jcriterion
from brainfm_tpu.synth import sampler as jsampler
from brainfm_tpu.synth.sharded import stack_items as jstack_items
from brainfm_tpu.train import loop as jloop
from brainfm_tpu_torch.config import load_config as tload
from brainfm_tpu_torch.infer import Inferencer
from brainfm_tpu_torch.models import build_inpaint_model, build_model
from brainfm_tpu_torch.models.criterion import make_criterion
from brainfm_tpu_torch.scripts import train as train_script
from brainfm_tpu_torch.synth import SubjectBank, datasets, sampler
from brainfm_tpu_torch.synth.batch import stack_items
from brainfm_tpu_torch.train import checkpoint as ckpt
from brainfm_tpu_torch.train import loop
from brainfm_tpu_torch.train.step import (TrainState, build_optimizer,
                                          make_train_step)

from _torch_train_util import (jax_model, joint_cfg, np_batch, port_model,
                               to_jax, to_torch)

# fp64 on both sides; only summation order differs
LOSS_RTOL = 1e-10


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


# ------------------------------------------------- against the JAX package

@pytest.fixture(scope="module")
def jax_joint(x64):
    return jax_model()


@pytest.mark.parametrize("accum", [1, 2])
def test_eval_step_matches_jax(jax_joint, accum):
    """make_eval_step (no gradients recorded) against the JAX package's,
    monolithic and in k=2 sample chunks: every loss and loss_total at
    rtol 1e-10."""
    jcfg, jm, params = jax_joint
    _, jw, jfn = jcriterion(jcfg)
    batch = np_batch(3, jcfg.n_labels)
    want = jloop.make_eval_step(jm, jcfg, jw, jfn, sample_accum=accum)(
        params, to_jax(batch))
    cfg, model = port_model(params)
    _, w, fn = make_criterion(cfg)
    got = loop.make_eval_step(model, cfg, w, fn, sample_accum=accum,
                              amp=False)(model, to_torch(batch))
    assert set(got) == set(want)
    for k in want:
        assert not got[k].requires_grad
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("condition", [None, "mask", "flip", "mask+flip"])
def test_apply_condition_matches_jax(condition):
    rng = np.random.default_rng(4)
    batch = {"samples": {"input": rng.random((2, 3, 5, 6, 4, 1)),
                         "bias_field_log": rng.random((2, 3, 5, 6, 4, 1))},
             "targets": {"pathology": (rng.random((2, 1, 5, 6, 4, 1))
                                       < 0.3).astype(np.float64)}}
    want = jloop.apply_condition(to_jax(batch), condition)
    got = loop.apply_condition(to_torch(batch), condition)
    assert set(got) == set(want)
    for k in ("input", "bias_field_log"):
        np.testing.assert_array_equal(got["samples"][k].numpy(),
                                      np.asarray(want["samples"][k]))
    if condition is None:
        assert "cond" not in got
    else:
        np.testing.assert_array_equal(got["cond"].numpy(),
                                      np.asarray(want["cond"]))


def test_stack_items_matches_jax():
    """Volume targets gain (B, 1, ...); lower-rank targets stack as they
    are; pathology_prob and surface_* are dropped; samples stack."""
    rng = np.random.default_rng(5)
    items = [({"T1": rng.random((4, 5, 3, 1)), "age": rng.random(()),
               "pathology_prob": rng.random((4, 5, 3, 1)),
               "surface_field": rng.random((4, 5, 3, 3))},
              {"input": rng.random((2, 4, 5, 3, 1))}) for _ in range(3)]
    want = jstack_items([to_jax(t) for t, _ in items],
                        [to_jax(s) for _, s in items])
    got = stack_items([to_torch(t) for t, _ in items],
                      [to_torch(s) for _, s in items])
    assert set(got["targets"]) == set(want["targets"]) == {"T1", "age"}
    assert tuple(got["targets"]["T1"].shape) == (3, 1, 4, 5, 3, 1)
    for part in ("targets", "samples"):
        for k, v in want[part].items():
            np.testing.assert_array_equal(got[part][k].numpy(),
                                          np.asarray(v))


@pytest.mark.parametrize("weighted", [False, True])
def test_sampler_matches_jax_draw_for_draw(weighted):
    kw = dict(dataset_probs=[0.3, 0.7], seed=11, process_index=2,
              subject_weights=[None, np.arange(1, 6)] if weighted else None)
    a = sampler.WeightedSubjectSampler([3, 5], **kw)
    b = jsampler.WeightedSubjectSampler([3, 5], **kw)
    for epoch in (0, 7):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        assert a.sample(40) == b.sample(40)
        assert a.sample_grouped(9, 4) == b.sample_grouped(9, 4)
    probs = {"T1": 0.3, "T2": 0.6, "CT": 0.9}
    ra, rb = np.random.default_rng(3), np.random.default_rng(3)
    for avail in ({"T1", "T2"}, {"CT"}, set()) * 20:
        assert sampler.choose_modality(ra, probs, avail) == \
            jsampler.choose_modality(rb, probs, avail)


# ------------------------------------------------------------ checkpoints

def _trained_state(seed=0, steps=1):
    """A small fp64 model and AdamW after `steps` steps (so the optimizer
    holds moments and step counts)."""
    torch.manual_seed(seed)
    cfg, model = build_model(joint_cfg(tload), device="cpu")
    model.double()
    opt = build_optimizer(cfg, model.parameters())
    state = TrainState(model, opt, 0)
    _, w, fn = make_criterion(cfg)
    step = make_train_step(model, cfg, w, fn, opt, amp=False)
    for i in range(steps):
        state, _ = step(state, to_torch(np_batch(i, cfg.n_labels)), 1e-3,
                        1e-2)
    return cfg, state


def _state_bytes(state):
    out = {f"p.{k}": v.numpy().tobytes()
           for k, v in state.model.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            out[f"o.{i}.{k}"] = v.numpy().tobytes()
    return out


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    """Model, optimizer state (moments and step counts) and step come back
    bitwise into a model and optimizer of other values; the extras read
    back; the weights serve through Inferencer(ckpt_path=<dir>)."""
    _, state = _trained_state(steps=2)
    state.step = 2
    path = ckpt.save_checkpoint(str(tmp_path / "ckp"), 2, state,
                                extra={"epoch": 0, "best_val_stats": None})
    assert path.endswith("ckpt_000002") and ckpt.is_checkpoint_dir(path)
    assert ckpt.read_extra(path) == {"epoch": 0, "best_val_stats": None}
    cfg, other = _trained_state(seed=1, steps=1)
    loaded = ckpt.load_checkpoint(path, other)
    assert loaded.step == 2
    assert _state_bytes(loaded) == _state_bytes(state)
    inf = Inferencer(cfg, ckpt_path=path, compute_dtype=torch.float64,
                     device="cpu")
    for k, v in inf.model.state_dict().items():
        assert torch.equal(v, state.model.state_dict()[k]), k


def test_async_save_snapshots_before_returning(tmp_path):
    """block=False copies the state before it returns: a step taken while
    the files are written does not leak into the checkpoint."""
    _, state = _trained_state()
    before = _state_bytes(state)
    path = ckpt.save_checkpoint(str(tmp_path), 1, state, block=False)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    ckpt.finalize_pending()
    _, other = _trained_state(seed=1)
    assert _state_bytes(ckpt.load_checkpoint(path, other)) == before


def test_keep_gc_sidecars_best_rename_and_latest(tmp_path):
    """keep=2 leaves the two newest step checkpoints (numeric order:
    ckpt_1000000 after ckpt_999999) with their extras moved in; the best
    checkpoint survives the GC and its predecessor becomes ckpt_best_bk;
    a sidecar is read when the directory has no extra.json."""
    _, state = _trained_state()
    d = str(tmp_path)
    ckpt.save_best_checkpoint(d, 5, state, extra={"v": 1})
    for s in (5, 999999, 1000000):
        ckpt.save_checkpoint(d, s, state, extra={"step": s}, keep=2,
                             block=False)
    ckpt.save_best_checkpoint(d, 7, state, extra={"v": 2})
    ckpt.finalize_pending()
    assert sorted(os.listdir(d)) == ["ckpt_1000000", "ckpt_999999",
                                     "ckpt_best", "ckpt_best_bk"]
    assert ckpt.latest_checkpoint(d).endswith("ckpt_1000000")
    assert ckpt.step_from_path(ckpt.latest_checkpoint(d)) == 1000000
    assert ckpt.read_extra(os.path.join(d, "ckpt_999999")) == {"step": 999999}
    assert ckpt.read_extra(os.path.join(d, "ckpt_best")) == {"v": 2}
    assert ckpt.read_extra(os.path.join(d, "ckpt_best_bk")) == {"v": 1}
    os.replace(os.path.join(d, "ckpt_999999", "extra.json"),
               os.path.join(d, "ckpt_999999.extra.json"))
    assert ckpt.read_extra(os.path.join(d, "ckpt_999999")) == {"step": 999999}
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None


# ------------------------------------------------------------------ train()

TRAIN_SIZE = (16, 16, 16)
BANK = (24, 24, 24)


def _small_train_cfg(n_epochs):
    cfg = joint_cfg(tload, size=TRAIN_SIZE)
    cfg.n_epochs, cfg.remat = n_epochs, False
    return cfg


def _bank():
    bank = SubjectBank(BANK)
    bank.add_debug_subject(seed=0, extent=(20, 22, 20))
    bank.add_debug_subject(seed=1, extent=(22, 20, 21))
    return bank


def _train(out_dir, n_epochs, resume=None):
    torch.manual_seed(0)
    cfg, model = build_model(_small_train_cfg(n_epochs), device="cpu")
    _, w, fn = make_criterion(cfg)
    return loop.train(cfg, model, w, fn, _bank(), str(out_dir),
                      itr_per_epoch=2, n_val_items=1, log_itr=1,
                      resume=resume)


def test_train_writes_logs_checkpoints_and_resumes_bitwise(tmp_path):
    """2 epochs x 2 iterations: log.txt holds one line per epoch with the
    train and val losses, ckp/ holds both epoch checkpoints and
    ckpt_best, and every step is finite and applied. A run stopped after
    epoch 0 and resumed from its checkpoint ends bitwise where the
    uninterrupted run ends."""
    full = _train(tmp_path / "full", 2)
    out = tmp_path / "full"
    lines = [json.loads(s) for s in open(out / "log.txt")]
    assert [s["epoch"] for s in lines] == [0, 1]
    for s in lines:
        assert np.isfinite(s["train_loss_total"]) and s["train_skipped"] == 0
        assert np.isfinite(s["val_loss_total"])
    assert {"ckpt_000002", "ckpt_000004", "ckpt_best"} <= set(
        os.listdir(out / "ckp"))
    assert ckpt.read_extra(str(out / "ckp" / "ckpt_000004"))["epoch"] == 1
    assert full.step == 4

    _train(tmp_path / "part", 1)
    resumed = _train(tmp_path / "part", 2,
                     resume=str(tmp_path / "part" / "ckp" / "ckpt_000002"))
    assert resumed.step == 4
    assert _state_bytes(resumed) == _state_bytes(full)


def test_val_set_is_fixed_and_staging_ships_uncached():
    """make_val_set draws the same batches every time, staged or cached;
    staged batches live on the host; SubjectBank.stage copies without
    caching."""
    cfg = _small_train_cfg(1)
    cfg, _ = build_model(cfg, device="cpu")
    from brainfm_tpu_torch.synth import SynthStatic, knobs_from_cfg

    scfg = SynthStatic.from_cfg(cfg)
    bank = _bank()
    knobs = {"synth": knobs_from_cfg(cfg, scfg, "synth")}
    sets = [loop.make_val_set(bank, scfg, tuple(cfg.tasks), ("synth",), knobs,
                              seed=3, n_items=2, stage_host=host,
                              device="cpu") for host in (False, True, False)]
    for other in sets[1:]:
        for a, b in zip(sets[0], other):
            for part in ("samples", "targets"):
                for k in a[part]:
                    assert torch.equal(a[part][k], b[part][k]), k
    staged = bank.stage(1, "cpu")
    cached = bank.to_device(1, "cpu")
    assert staged.keys() == cached.keys()
    assert all(torch.equal(staged[k], cached[k]) for k in staged)
    assert bank.stage(1, "cpu")["gen"] is not staged["gen"]


# --------------------------------------------------------------------- CLI

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture
def small_bank(monkeypatch):
    """The CLI's datasets at a 24^3 bank with 22^3 debug subjects (the
    script's are 192^3 and 160^3)."""
    monkeypatch.setattr(train_script, "build_datasets", functools.partial(
        datasets.build_datasets, bank_shape=(24, 24, 24),
        debug_extent=(22, 22, 22)))


def _cli_cfgs(tmp_path, gen_extra=""):
    tr, gen = tmp_path / "tr.yaml", tmp_path / "gen.yaml"
    tr.write_text("job_name: cli\nf_maps: 8\nnum_levels: 2\n"
                  "task_f_maps: [8]\nremat: False\n")
    gen.write_text("generator:\n  size: [16, 16, 16]\n" + gen_extra)
    return ["--train_cfg", str(tr), "--gen_cfg", str(gen)]


def _data_root_cfg(tmp_path):
    """A generator YAML over a procedural data root of two datasets in the
    DATASET_SETUPS layout (chip_smoke.write_subject_root)."""
    data, split = chip_smoke.write_subject_root(str(tmp_path / "root"),
                                                (20, 22, 21))
    return (f"data_root: {data}\nsplit_root: {split}\n"
            "dataset_names: [HCP, ATLAS]\n")


def test_cli_debug_run_on_cpu(tmp_path, capsys, small_bank):
    """Without a data root: one debug subject in each of the eight
    datasets, trained on their stream."""
    out = tmp_path / "run"
    assert train_script.main([*_cli_cfgs(tmp_path), "--device", "cpu",
                              "--debug", "--no_amp", "--out_dir",
                              str(out)]) == 0
    text = capsys.readouterr().out
    assert "final step 2" in text
    assert "datasets: {'ADHD': 1, 'HCP': 1, 'AIBL': 1, 'OASIS': 1" in text
    assert (out / "log.txt").is_file()
    assert (out / "ckp" / "ckpt_000002").is_dir()


# ------------------------------------------------------- not ported (yet)

@pytest.mark.parametrize("kw", [{"stream": "debug datasets"},
                                {"mesh": object()}, {"fsdp": True},
                                {"twostage_models": "the pair"},
                                {"vis_itr": 5}])
def test_train_checks_its_arguments(tmp_path, kw):
    """A mesh that is not a DeviceMesh raises TypeError, and fsdp=True
    without a mesh ValueError with the JAX loop's message (mesh training
    itself is tests/test_torch_mesh_train.py). Three cases that were
    refused before their slices were ported train: stream= (two debug
    datasets' stream, no bank), twostage_models= (the joint config on an
    'a+b' backbone: stage 0 learns through stage 1's losses alone) and
    vis_itr (the montage, the feature strips of the config's
    `visualizer` section)."""
    torch.manual_seed(0)
    cfg, model = build_model(_small_train_cfg(1), device="cpu")
    _, w, fn = make_criterion(cfg)
    if "twostage_models" in kw:
        cfg = _small_train_cfg(1)
        cfg.backbone = "unet3d+unet3d"
        cfg, pair = build_inpaint_model(cfg, device="cpu")
        before = {k: v.clone() for k, v in pair.state_dict().items()}
        state = loop.train(cfg, None, w, fn, _bank(), str(tmp_path),
                           itr_per_epoch=2, n_val_items=1,
                           twostage_models=pair)
        assert state.step == 2 and state.model is pair
        assert all(not torch.equal(before[k], v)
                   for k, v in pair.state_dict().items()
                   if k.endswith("conv.weight"))
        line = json.loads(open(tmp_path / "log.txt").read())
        assert np.isfinite(line["val_loss_total"])
        return
    if "stream" in kw:
        cfg.dataset_names = ["HCP", "ATLAS"]
        ds = datasets.build_datasets(cfg, cfg.tasks, device="cpu",
                                     bank_shape=BANK,
                                     debug_extent=(20, 22, 20))
        state = loop.train(cfg, model, w, fn, None, str(tmp_path),
                           itr_per_epoch=2, n_val_items=1,
                           stream=ds["_concat"])
        assert state.step == 2
        line = json.loads(open(tmp_path / "log.txt").read())
        assert np.isfinite(line["val_loss_total"])
        return
    if "vis_itr" in kw:
        state = loop.train(cfg, model, w, fn, _bank(), str(tmp_path),
                           itr_per_epoch=2, n_val_items=1, **kw)
        assert state.step == 2
        assert os.listdir(tmp_path / "vis") == ["vis_0000000.png"]
        assert os.listdir(tmp_path / "vis_feat") == ["feat_0000000.png"]
        return
    if "mesh" in kw:
        with pytest.raises(TypeError, match="DeviceMesh"):
            loop.train(cfg, model, w, fn, _bank(), str(tmp_path), **kw)
        return
    with pytest.raises(ValueError, match="fsdp=True requires a mesh"):
        loop.train(cfg, model, w, fn, _bank(), str(tmp_path), **kw)


def test_train_refuses_the_critic_flag(tmp_path):
    """losses.implicit_pathol, refused before the critic was ported, now
    trains against a random-init frozen critic (with its warning): the
    implicit-pathology losses are logged for training and validation."""
    torch.manual_seed(0)
    cfg = _small_train_cfg(1)
    cfg.losses.implicit_pathol = True
    cfg.critic_f_maps, cfg.critic_num_levels = 8, 2
    cfg, model = build_model(cfg, device="cpu")
    _, w, fn = make_criterion(cfg)
    with pytest.warns(UserWarning, match="RANDOM"):
        state = loop.train(cfg, model, w, fn, _bank(), str(tmp_path),
                           itr_per_epoch=2, n_val_items=1)
    assert state.step == 2
    line = json.loads(open(tmp_path / "log.txt").read())
    for k in ("train_loss_implicit_pathol_ce", "val_loss_implicit_pathol_ce",
              "train_loss_implicit_pathol_dice"):
        assert np.isfinite(line[k]), k


@pytest.mark.parametrize("case", ["mesh", "fsdp", "eval_only", "data_root",
                                  "twostage"])
def test_cli_checks_its_arguments(tmp_path, capsys, small_bank, case):
    """--fsdp without --mesh is an argparse error, and --mesh 2 in a
    one-process world raises the mesh's world-size error. The cases that
    were refused before their slices were ported run: a data root in the
    DATASET_SETUPS layout
    trains on its subjects (read through the codec); --eval_only without
    --resume is an error, and with the checkpoint of that run scores the
    stream's validation set; a two-stage backbone trains the pair."""
    args = [*_cli_cfgs(tmp_path, _data_root_cfg(tmp_path)
                       if case in ("eval_only", "data_root") else ""),
            "--device", "cpu", "--debug", "--no_amp",
            "--out_dir", str(tmp_path / "run")]
    if case in ("eval_only", "data_root"):
        assert train_script.main(args) == 0
        text = capsys.readouterr().out
        assert "datasets: {'HCP': 2, 'ATLAS': 2}" in text
        assert "final step 2" in text
        if case == "eval_only":
            with pytest.raises(SystemExit):
                train_script.main([*args, "--eval_only"])
            ckpt = str(tmp_path / "run" / "ckp" / "ckpt_000002")
            assert train_script.main([*args, "--eval_only", "--resume",
                                      ckpt]) == 0
            lines = [ln for ln in capsys.readouterr().out.splitlines()
                     if ln.startswith("val[")]
            assert len(lines) == 2 and "'loss_total'" in lines[0]
        return
    if case == "twostage":
        with open(tmp_path / "tr.yaml", "a") as f:
            f.write("backbone: unet3d+unet3d\n")
        assert train_script.main(args) == 0
        assert "final step 2" in capsys.readouterr().out
        state = torch.load(tmp_path / "run" / "ckp" / "ckpt_000002" /
                           "model.pt", weights_only=True)
        assert {k.split(".")[0] for k in state} == {"pathol", "task"}
        return
    if case == "fsdp":
        with pytest.raises(SystemExit):
            train_script.main([*args, "--fsdp"])
        assert "--fsdp requires --mesh" in capsys.readouterr().err
        return
    with pytest.raises(ValueError, match=r"mesh 2x1 != 1 devices"):
        train_script.main([*args, "--mesh", "2"])


def test_build_bank_reads_the_flat_layout(tmp_path):
    """scripts/train.py::build_bank (the flat layout of
    scripts/demo_generator.py): <id>.T1w with its generation labels,
    segmentation, distance and registration companions, through
    SubjectBank.add_many; a T1 without generation labels is skipped."""
    from brainfm_tpu_torch.config import AttrDict
    from brainfm_tpu_torch.utils.nifti import save_nifti

    rng = np.random.default_rng(0)
    shape = (14, 15, 13)
    for sid in ("a", "b"):
        lab = rng.integers(0, 30, shape).astype(np.int32)
        save_nifti(str(tmp_path / f"{sid}.T1w.nii.gz"),
                   rng.random(shape).astype(np.float32))
        if sid == "b":
            continue
        save_nifti(str(tmp_path / f"{sid}.generation_labels.nii"), lab)
        save_nifti(str(tmp_path / f"{sid}.seg_x.nii.gz"), lab)
        for k in ("lp", "lw", "rp", "rw"):
            save_nifti(str(tmp_path / f"{sid}.{k}_dist_map.nii"),
                       rng.random(shape).astype(np.float32))
        for a in "xyz":
            save_nifti(str(tmp_path / f"{sid}.mni_reg.{a}.nii.gz"),
                       rng.random(shape).astype(np.float32))
    cfg = AttrDict(data_root=str(tmp_path), segment_prefix="seg_x")
    bank = train_script.build_bank(cfg, bank_shape=(16, 16, 16))
    assert len(bank) == 1
    subj = bank.subjects[0]
    assert list(subj) == ["T1", "gen", "seg", "dist", "reg", "shape"]
    assert subj["dist"].shape == (16, 16, 16, 4)
    assert subj["reg"].shape == (16, 16, 16, 3)
    assert subj["shape"].tolist() == list(shape)


def test_training_entry_points_refuse_cpu_fallback(tmp_path, small_bank):
    """Without CUDA the CLI and the val set raise unless asked for the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_script.main([*_cli_cfgs(tmp_path), "--debug", "--out_dir",
                           str(tmp_path / "run")])
    with pytest.raises(RuntimeError, match="CUDA"):
        loop.make_val_set(_bank(), None, (), ("synth",), {}, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        _bank().stage(0)
