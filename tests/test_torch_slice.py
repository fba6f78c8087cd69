"""The port's first slice against the JAX package on the CPU, end to end:
synth_item (the flagship generator config, cut to a 32^3 output from a
48^3 bank) -> the joint model (cut to f_maps 8, L5) -> apply_processors.
Every random draw is made on the JAX side with the key splits of
`_synth_item_impl` and fed to the port's synth_item(draws=...).

Also: the port and chip_smoke.py import nothing of JAX, and chip_smoke.py
fails, printing no result, on a host without a GPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brainfm_tpu.config import load_config as jload
from brainfm_tpu.models import build_model as jbuild
from brainfm_tpu.models.build import apply_processors as japply
from brainfm_tpu.synth import engine as jengine
from brainfm_tpu.synth.params import SynthStatic as JSynthStatic
from brainfm_tpu_torch.config import load_config as tload
from brainfm_tpu_torch.config import merge_missing
from brainfm_tpu_torch.models import (apply_processors, build_model,
                                      from_jax_params)
from brainfm_tpu_torch.synth import engine as tengine
from brainfm_tpu_torch.synth.params import SynthStatic

import _jax_draws as jd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = (32, 32, 32)
# fp32 both sides. The deformation grid comes from matrix products summed
# in other orders (~1e-6 voxel), so interpolated values differ by their
# local gradient times that; targets and samples are normalized to O(1)
TARGET_ATOL = 1e-4
SAMPLE_ATOL = 1e-4
# a coordinate on a .5 tie or a label boundary may round the other way
SEG_AGREE = 0.9999
# fp64 models on the same input: only summation order differs
MODEL_ATOL = 1e-9
# fp64 models, each on its own package's samples (which differ by up to
# SAMPLE_ATOL): the per-voxel unit normalization of the last feature
# magnifies that difference where the feature's norm is small
CHAIN_ATOL = 5e-3


def flagship_cfg(load):
    gen = load([os.path.join(ROOT, "cfgs/generator/default.yaml"),
                "brain_id"], cfg_dir=os.path.join(ROOT, "cfgs/generator/train"))
    tr = load([os.path.join(ROOT, "cfgs/trainer/default_train.yaml"),
               "joint"], cfg_dir=os.path.join(ROOT, "cfgs/trainer/train"))
    merge_missing(tr, gen)
    tr.f_maps, tr.num_levels, tr.task_f_maps = 8, 5, [8]
    tr.generator.size = list(SIZE)
    return tr


@pytest.fixture(scope="module")
def item():
    """(jax target, jax samples, port target, port samples, cfgs) for one
    key."""
    jcfg, jm = jbuild(flagship_cfg(jload))
    tcfg, tm = build_model(flagship_cfg(tload), device="cpu")
    jscfg = JSynthStatic.from_cfg(jcfg)
    tscfg = SynthStatic.from_cfg(tcfg)
    assert jscfg.all_samples == 4 and jscfg.size == SIZE
    jbank = jengine.SubjectBank(bank_shape=(48, 48, 48))
    jbank.add_debug_subject(seed=0, extent=(40, 44, 42))
    tbank = tengine.SubjectBank(bank_shape=(48, 48, 48))
    tbank.add_debug_subject(seed=0, extent=(40, 44, 42))
    jknobs = jengine.knobs_from_cfg(jcfg, jscfg, "synth")
    tknobs = tengine.knobs_from_cfg(tcfg, tscfg, "synth")
    key = jax.random.PRNGKey(2)
    jt, js = jengine.synth_item(key, jbank.to_device(0), jscfg, jcfg.tasks,
                                "synth", jknobs)
    draws = jd.item_draws(key, jscfg, "synth",
                          {k: np.asarray(v) for k, v in jknobs.items()},
                          (48, 48, 48))
    tt, ts = tengine.synth_item(None, tbank.to_device(0, "cpu"), tscfg,
                                tcfg.tasks, "synth", tknobs, draws=draws)
    return jt, js, tt, ts, (jcfg, jm, tcfg, tm)


def test_slice_generator_matches_jax(item):
    jt, js, tt, ts, _ = item
    assert set(tt) == set(jt) == {"T1", "segmentation", "distance",
                                  "registration"}
    assert set(ts) == set(js) == {"input", "bias_field_log"}
    for k in jt:
        assert tuple(tt[k].shape) == jt[k].shape, k
        if k == "segmentation":
            agree = np.mean(tt[k].numpy().argmax(-1)
                            == np.asarray(jt[k]).argmax(-1))
            assert agree >= SEG_AGREE, agree
            np.testing.assert_array_equal(tt[k].numpy().sum(-1), 1.0)
        else:
            np.testing.assert_allclose(tt[k].numpy(), np.asarray(jt[k]),
                                       atol=TARGET_ATOL, err_msg=k)
    for k in js:
        assert tuple(ts[k].shape) == js[k].shape == (4, *SIZE, 1)
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   atol=SAMPLE_ATOL, err_msg=k)


def test_slice_model_matches_jax(item):
    """Both models, same weights, at fp64: on the same input (the JAX
    sample), and each on its own package's samples."""
    jt, js, tt, ts, (_, _, tcfg, tm) = item
    jax.config.update("jax_enable_x64", True)
    try:
        jcfg, jm = jbuild(flagship_cfg(jload), compute_dtype=jnp.float64)
        x = jnp.asarray(js["input"], jnp.float64)
        params = jax.jit(jm.init)(jax.random.PRNGKey(0), x[:1])
        params = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
        want = japply(jax.jit(jm.apply)(params, x), jcfg)
    finally:
        jax.config.update("jax_enable_x64", False)
    tm = tm.double().eval()
    tm.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        same = apply_processors(tm(torch.from_numpy(np.asarray(x))), tcfg)
        own = apply_processors(tm(ts["input"].double()), tcfg)
    heads = {"T1": 1, "T2": 1, "FLAIR": 1, "CT": 1, "bias_field_log": 1,
             "segmentation": 56, "distance": 4, "registration": 3}
    for k, ch in heads.items():
        assert tuple(own[k].shape) == want[k].shape == (4, *SIZE, ch)
        np.testing.assert_allclose(same[k].numpy(), np.asarray(want[k]),
                                   atol=MODEL_ATOL, err_msg=k)
        np.testing.assert_allclose(own[k].numpy(), np.asarray(want[k]),
                                   atol=CHAIN_ATOL, err_msg=k)
        assert torch.isfinite(own[k]).all()
    np.testing.assert_allclose(own["segmentation"].sum(-1).numpy(), 1.0,
                               atol=1e-9)


def _with_more_contrasts(bank):
    """Add T2/FLAIR/CT and distance maps to the debug subject, so every
    target branch of make_targets runs."""
    subj = bank.subjects[0]
    t1 = subj["T1"].astype(np.float32)
    subj.update(T2=t1[::-1].copy() * 0.7, FLAIR=np.sqrt(t1 + 1.0),
                CT=t1 * 9.0, T1_DM=t1 / 50.0 - 1.0, CT_DM=t1 / 70.0 - 0.5)
    return bank


@pytest.mark.parametrize("left", [False, True])
def test_slice_real_mode_matches_jax(left):
    """input_mode='T1': the real image warped once (K1 linear, C=1), then
    the real-mode augmentation chain per sample; every target branch (T2,
    FLAIR, CT, the distance maps), and the left-hemisphere mask."""
    tasks = ["T1", "T2", "FLAIR", "CT", "segmentation", "distance",
             "registration", "bias_field"]
    jcfg = flagship_cfg(jload)
    jcfg.generator.left_hemis_only = left
    tcfg = flagship_cfg(tload)
    tcfg.generator.left_hemis_only = left
    jscfg = JSynthStatic.from_cfg(jcfg)
    tscfg = SynthStatic.from_cfg(tcfg)
    jbank = jengine.SubjectBank(bank_shape=(48, 48, 48))
    jbank.add_debug_subject(seed=1, extent=(40, 44, 42))
    tbank = tengine.SubjectBank(bank_shape=(48, 48, 48))
    tbank.add_debug_subject(seed=1, extent=(40, 44, 42))
    _with_more_contrasts(jbank)
    _with_more_contrasts(tbank)
    jknobs = jengine.build_knobs_stack(jscfg, "T1")
    key = jax.random.PRNGKey(5)
    jt, js = jengine.synth_item(key, jbank.to_device(0), jscfg, tasks, "T1",
                                jknobs)
    draws = jd.item_draws(key, jscfg, "T1",
                          {k: np.asarray(v) for k, v in jknobs.items()},
                          (48, 48, 48))
    tt, ts = tengine.synth_item(None, tbank.to_device(0, "cpu"), tscfg,
                                tasks, "T1",
                                tengine.build_knobs_stack(tscfg, "T1"),
                                draws=draws)
    assert set(ts) == set(js) == {"input", "bias_field_log"}
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   atol=SAMPLE_ATOL, err_msg=k)
    assert set(tt) == set(jt)
    assert {"T2", "FLAIR", "CT", "T1_DM", "CT_DM"} <= set(tt)
    for k in jt:
        assert tuple(tt[k].shape) == jt[k].shape, k
        if k == "segmentation":
            agree = np.mean(tt[k].numpy().argmax(-1)
                            == np.asarray(jt[k]).argmax(-1))
            assert agree >= SEG_AGREE, agree
        else:
            np.testing.assert_allclose(tt[k].numpy(), np.asarray(jt[k]),
                                       atol=TARGET_ATOL, err_msg=k)


_BLOCK = r"""
import importlib, importlib.abc, pkgutil, sys
sys.path.insert(0, {root!r})


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "brainfm_tpu"):
            raise ImportError("blocked: " + name)


sys.meta_path.insert(0, Block())
import brainfm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(brainfm_tpu_torch.__path__,
                                               "brainfm_tpu_torch.")]
for n in names + ["chip_smoke"]:
    importlib.import_module(n)
assert not any(m.split(".")[0] in ("jax", "brainfm_tpu") for m in sys.modules)
print("imported", len(names) + 1)
"""


def test_port_imports_nothing_of_jax():
    out = subprocess.run([sys.executable, "-c", _BLOCK.format(root=ROOT)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_chip_smoke_fails_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_entry_points_refuse_cpu_fallback(tmp_path):
    """Without CUDA the entry points raise unless asked for the CPU:
    build_model, the subject bank, the Inferencer, prepare_image, the
    serving CLI, the Evaluator, the evaluation CLI, the generator demo and
    the device-memory counters."""
    from brainfm_tpu_torch.infer import Inferencer, prepare_image
    from brainfm_tpu_torch.models.evaluator import Evaluator
    from brainfm_tpu_torch.scripts import demo_generator, demo_test
    from brainfm_tpu_torch.scripts import test as test_cli
    from brainfm_tpu_torch.utils import profiling
    from brainfm_tpu_torch.utils.nifti import save_nifti

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(flagship_cfg(tload))
    bank = tengine.SubjectBank(bank_shape=(8, 8, 8))
    bank.add_debug_subject(seed=0, extent=(8, 8, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        bank.to_device(0)
    assert bank.to_device(0, "cpu")["gen"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        Inferencer(flagship_cfg(tload))
    img = str(tmp_path / "v.nii")
    save_nifti(img, np.ones((8, 8, 8), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        prepare_image(img)
    assert prepare_image(img, device="cpu")[0].device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        demo_test.main([img, "--save_dir", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="CUDA"):
        Evaluator(["recon_psnr"]).eval_files(img, img)
    assert Evaluator(["recon_l1"], device="cpu").eval_files(
        img, img) == {"recon_l1": 0.0}
    for argv in (["--input_glob", img], ["--pred_glob", img]):
        with pytest.raises(RuntimeError, match="CUDA"):
            test_cli.main([*argv, "--save_dir", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="CUDA"):
        demo_generator.main(["--save_dir", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.device_memory_stats()
