"""The port's training visualizer, profiling hooks and generator demo
against the JAX package on the CPU: PNG bytes of TaskVisualizer and
FeatVisualizer for equal arrays; train(vis_itr=1), single-model and
two-stage, writes the JAX loop's files and leaves the training state
bitwise as vis_itr=0 does; a torch.profiler trace and the step timer; the
demo generator's file names and shapes against the JAX demo's, and a
replay of its items from their recorded draws."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from brainfm_tpu.config import load_config as jload
from brainfm_tpu.models import build_model as jbuild_model
from brainfm_tpu.models.build import build_inpaint_model as jinpaint
from brainfm_tpu.models.criterion import make_criterion as jcriterion
from brainfm_tpu.synth.engine import SubjectBank as JSubjectBank
from brainfm_tpu.train import loop as jloop
from brainfm_tpu.utils import visualizer as jvis
from brainfm_tpu_torch.config import load_config as tload
from brainfm_tpu_torch.models import build_inpaint_model, build_model
from brainfm_tpu_torch.models.criterion import make_criterion
from brainfm_tpu_torch.scripts import demo_generator
from brainfm_tpu_torch.synth import SubjectBank, SynthStatic, synth_item
from brainfm_tpu_torch.synth.engine import build_knobs_stack
from brainfm_tpu_torch.train import loop
from brainfm_tpu_torch.utils import profiling, visualizer
from brainfm_tpu_torch.utils.nifti import load_nifti

from _torch_train_util import joint_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = (16, 16, 16)
BANK = (24, 24, 24)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_png_bytes_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    samples = {"input": rng.random((2, 12, 10, 14, 1)).astype(np.float32)}
    targets = {"T1": rng.random((12, 10, 14, 1)).astype(np.float32),
               "segmentation": rng.random((12, 10, 14, 5)).astype(np.float32),
               "flat": np.zeros((12, 10, 14, 1), np.float32),
               "scalar": np.float32(3.0)}
    outputs = {"T1": rng.random((2, 12, 10, 14, 1)).astype(np.float32),
               "segmentation": rng.random((2, 12, 10, 14, 5)).astype(
                   np.float32),
               "flat": np.full((2, 12, 10, 14, 1), np.nan, np.float32),
               "scalar": np.float32(1.0)}
    feat = rng.standard_normal((1, 2, 12, 10, 14, 13)).astype(np.float32)

    def t(d):
        return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}

    for names in (None, ["T1"]):
        want = jvis.TaskVisualizer(str(tmp_path / "j")).visualize(
            3, samples, targets, outputs, names)
        got = visualizer.TaskVisualizer(str(tmp_path / "t")).visualize(
            3, t(samples), t(targets), t(outputs), names)
        assert os.path.basename(got) == os.path.basename(want)
        assert _read(got) == _read(want)
    for n in (10, 4):
        want = jvis.FeatVisualizer(str(tmp_path / "j"), n).visualize(7, feat)
        got = visualizer.FeatVisualizer(str(tmp_path / "t"), n).visualize(
            7, torch.from_numpy(feat))
        assert _read(got) == _read(want)
    assert visualizer.TaskVisualizer(str(tmp_path / "t")).visualize(
        0, {}, {}, {}) is None


def _files(root):
    """Every file under the run's visualizer directories, relative."""
    out = []
    for sub in ("vis", "vis_feat"):
        for d, _, fs in os.walk(os.path.join(root, sub)):
            out += [os.path.relpath(os.path.join(d, f), root) for f in fs]
    return sorted(out)


def _cfgs(twostage):
    kw = dict(f_maps=8, num_levels=2, size=SIZE)
    if twostage:
        kw.update(gen="twostage", train="twostage")
    out = []
    for load in (jload, tload):
        cfg = joint_cfg(load, **kw)
        cfg.n_epochs, cfg.remat = 1, False
        cfg.visualizer.make_results = True
        cfg.visualizer.feat_vis_num = 3
        out.append(cfg)
    return out


def _port_train(cfg, out, twostage, vis_itr):
    torch.manual_seed(0)
    if twostage:
        cfg, model = build_inpaint_model(cfg, device="cpu")
    else:
        cfg, model = build_model(cfg, device="cpu")
    _, w, fn = make_criterion(cfg)
    bank = SubjectBank(BANK)
    bank.add_debug_subject(seed=0, extent=(20, 20, 20))
    return loop.train(cfg, None if twostage else model, w, fn, bank, out,
                      itr_per_epoch=2, n_val_items=1, vis_itr=vis_itr,
                      twostage_models=model if twostage else None)


def _state_bytes(state):
    out = {f"p.{k}": v.numpy().tobytes()
           for k, v in state.model.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            out[f"o.{i}.{k}"] = v.numpy().tobytes()
    return out


@pytest.mark.parametrize("twostage", [False, True])
def test_train_vis_writes_jax_files_and_leaves_state_bitwise(tmp_path,
                                                            twostage):
    jcfg, tcfg = _cfgs(twostage)
    if twostage:
        jcfg, jp, jt = jinpaint(jcfg)
        jmodel, pair = None, (jp, jt)
    else:
        jcfg, jmodel = jbuild_model(jcfg)
        pair = None
    _, jw, jfn = jcriterion(jcfg)
    jbank = JSubjectBank(bank_shape=BANK)
    jbank.add_debug_subject(seed=0, extent=(20, 20, 20))
    jloop.train(jcfg, jmodel, jw, jfn, jbank, str(tmp_path / "jax"),
                itr_per_epoch=2, n_val_items=1, vis_itr=1,
                twostage_models=pair)

    vis = _port_train(tcfg, str(tmp_path / "vis"), twostage, 1)
    plain = _port_train(_cfgs(twostage)[1], str(tmp_path / "plain"),
                        twostage, 0)
    files = _files(str(tmp_path / "vis"))
    assert files == _files(str(tmp_path / "jax"))
    assert "vis/vis_0000001.png" in files
    assert "vis_feat/feat_0000001.png" in files
    assert "vis/results_1/pd_T1.nii.gz" in files
    assert _files(str(tmp_path / "plain")) == []
    assert _state_bytes(vis) == _state_bytes(plain)
    for run in ("vis", "plain"):
        assert [json.loads(s)["train_loss_total"] for s in
                open(tmp_path / run / "log.txt")] == \
            [json.loads(s)["train_loss_total"]
             for s in open(tmp_path / "plain" / "log.txt")]


def test_profiling_trace_annotate_memory_and_timer(tmp_path):
    log = str(tmp_path / "trace")
    with profiling.trace(log):
        with profiling.annotate("matmul"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    files = os.listdir(log)
    assert len(files) == 1 and files[0].endswith(".json")
    assert "matmul" in open(os.path.join(log, files[0])).read()
    assert profiling.device_memory_stats("cpu") == {
        "bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    timer = profiling.StepTimer(warmup=2)
    for _ in range(5):
        timer.start()
        timer.stop(torch.ones(3))
    assert len(timer.times) == 3 and timer.mean >= 0


def _small_bank(cfg):
    del cfg
    bank = SubjectBank(BANK)
    bank.add_debug_subject(seed=0, extent=(20, 20, 20))
    return bank


def test_demo_generator_matches_jax_names_and_shapes(tmp_path, monkeypatch):
    gen = tmp_path / "gen.yaml"
    gen.write_text(f"size: {list(SIZE)}\n")
    sys.path.insert(0, ROOT)
    try:
        import scripts.train as jtrain_script
        spec = importlib.util.spec_from_file_location(
            "jax_demo_generator",
            os.path.join(ROOT, "scripts", "demo_generator.py"))
        jdemo = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(jdemo)
    finally:
        sys.path.remove(ROOT)

    def jbank(cfg):
        del cfg
        bank = JSubjectBank(bank_shape=BANK)
        bank.add_debug_subject(seed=0, extent=(20, 20, 20))
        return bank

    monkeypatch.setattr(jtrain_script, "build_bank", jbank)
    monkeypatch.setattr(sys, "argv", [
        "demo_generator.py", "--gen_cfg", str(gen), "--num_deformations",
        "2", "--save_dir", str(tmp_path / "jax")])
    jdemo.main()

    monkeypatch.setattr(demo_generator, "build_bank", _small_bank)
    record = []
    assert demo_generator.main([
        "--gen_cfg", str(gen), "--num_deformations", "2", "--save_dir",
        str(tmp_path / "port"), "--device", "cpu", "--seed", "3"],
        record=record) == 0
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert "d1_s0_input.nii.gz" in names
    for n in names:
        got = load_nifti(str(tmp_path / "port" / n))[0]
        assert got.shape == load_nifti(str(tmp_path / "jax" / n))[0].shape, n

    # each deformation replays from its recorded draws
    cfg = tload([os.path.join(ROOT, "cfgs/generator/default.yaml"),
                 str(gen)])
    scfg = SynthStatic.from_cfg(cfg)
    tasks = tuple(k for k, v in dict(cfg.task).items() if v)
    subj = _small_bank(None).to_device(0, "cpu")
    for d, rec in enumerate(record):
        _, samples = synth_item(None, subj, scfg, tasks, "synth",
                                build_knobs_stack(scfg, "synth"), draws=rec)
        got = load_nifti(str(tmp_path / "port" / f"d{d}_s0_input.nii.gz"))[0]
        np.testing.assert_array_equal(got, samples["input"][0, ..., 0]
                                      .numpy())
