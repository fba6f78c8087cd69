"""The port's training stream against the JAX package on the CPU: the
native codec (its own copy, built into brainfm_tpu_torch/_build/) and the
subject bank's ingest bitwise, the dataset stream's plan over two epochs,
one stream item with injected draws (a lesion from the pool warped by K1's
plain version, the surface task's inverse field), and the port's stream
training: a resume at an epoch boundary ends bitwise where an
uninterrupted run ends. The data root is chip_smoke.py's procedural one
(`write_subject_root`), in the DATASET_SETUPS layout with split files and
an age table."""

import copy
import gzip
import importlib.util
import json
import os
import shutil
import struct

import numpy as np
import pytest
import torch

import jax

from brainfm_tpu.config import AttrDict as JAttrDict
from brainfm_tpu.runtime import loader as jloader
from brainfm_tpu.synth import datasets as jdatasets
from brainfm_tpu.synth import engine as jengine
from brainfm_tpu_torch.config import AttrDict
from brainfm_tpu_torch.models import build_model
from brainfm_tpu_torch.models.criterion import make_criterion
from brainfm_tpu_torch.runtime import loader, native
from brainfm_tpu_torch.synth import datasets, engine
from brainfm_tpu_torch.utils import profiling
from brainfm_tpu_torch.synth.sampler import choose_modality
from brainfm_tpu_torch.train import loop
from brainfm_tpu_torch.utils.nifti import save_nifti

import _jax_draws as jd
from _torch_train_util import joint_cfg
from brainfm_tpu_torch.config import load_config as tload

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

BANK = (24, 24, 24)
EXTENT = (20, 22, 21)
# fp32 item, as tests/test_torch_pathology.py
TARGET_ATOL = 1e-4
SEG_AGREE = 0.9999
MASK_AGREE = 0.999


# ------------------------------------------------------------------ codec

def _nifti(path, data, slope=1.0, inter=0.0, dims=None):
    """A NIfTI-1 file with the given scaling; `dims` overrides dim[0..]
    (a trailing singleton frame)."""
    tmp = path + ".raw.nii"
    save_nifti(tmp, data)
    with open(tmp, "rb") as f:
        raw = bytearray(f.read())
    os.remove(tmp)
    struct.pack_into("<f", raw, 112, slope)
    struct.pack_into("<f", raw, 116, inter)
    if dims is not None:
        d = np.zeros(8, np.int16)
        d[:len(dims)] = dims
        raw[40:56] = d.tobytes()
    if path.endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(bytes(raw))
    else:
        with open(path, "wb") as f:
            f.write(bytes(raw))
    return path


@pytest.fixture(scope="module")
def codec_files(tmp_path_factory):
    """int16 with scaling (.nii.gz), float32 (.nii), uint8, a trailing
    singleton frame, two frames, a volume larger than the bank, and a
    .mgz."""
    d = tmp_path_factory.mktemp("codec")
    rng = np.random.default_rng(0)
    i16 = (rng.random((18, 20, 17)) * 3000 - 500).astype(np.int16)
    f32 = rng.standard_normal((18, 20, 17)).astype(np.float32)
    files = [
        _nifti(str(d / "i16.nii.gz"), i16, slope=0.37, inter=-12.5),
        _nifti(str(d / "f32.nii"), f32),
        _nifti(str(d / "u8.nii"), (rng.random((10, 30, 9)) * 255)
               .astype(np.uint8)),
        _nifti(str(d / "single.nii.gz"), f32[..., None],
               dims=[4, 18, 20, 17, 1]),
        _nifti(str(d / "frames.nii"), rng.standard_normal(
            (18, 20, 17, 2)).astype(np.float32)),
        _nifti(str(d / "big.nii.gz"), rng.standard_normal(
            (30, 12, 26)).astype(np.float32)),
    ]
    mgz = str(d / "vol.mgz")
    chip_smoke.write_mgz(mgz, f32)
    return files + [mgz]


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def test_codec_decodes_like_jax(codec_files):
    """decode_batch_with_shapes: the arena, the native extents and the
    multi-frame extras bitwise the JAX codec's; the library is built into
    _build/ for the generic target, keyed by the source's hash."""
    got = loader.VolCodec(BANK).decode_batch_with_shapes(codec_files)
    want = jloader.VolCodec(BANK).decode_batch_with_shapes(codec_files)
    assert _same(got[0], want[0])
    assert got[1] == want[1]
    assert got[1][0] == (18, 20, 17) and got[1][5] == (30, 12, 26)
    assert set(got[2]) == set(want[2]) == {4}
    assert _same(got[2][4], want[2][4])
    nii = codec_files[:4]
    assert _same(loader.VolCodec(BANK).decode_batch(nii),
                 jloader.VolCodec(BANK).decode_batch(nii))
    lib = loader.library_path()
    assert lib.parent.name == "_build" and lib.exists()
    assert "-march=native" not in loader.CXX_FLAGS
    assert loader.SOURCE.parent.parent.name == "brainfm_tpu_torch"


def test_codec_raises_on_a_broken_file(tmp_path, codec_files):
    bad = tmp_path / "cut.nii.gz"
    with open(codec_files[1], "rb") as f:
        raw = f.read()
    with gzip.open(bad, "wb") as f:
        f.write(raw[:400])
    with pytest.raises(IOError, match="truncated"):
        loader.VolCodec(BANK).decode_batch_with_shapes([str(bad)])


def test_codec_build_failure_raises_with_compiler_output(tmp_path,
                                                         monkeypatch):
    src = tmp_path / "volcodec.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(loader, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="volcodec build failed"):
        loader.build()


# ------------------------------------------------------------------- bank

def test_bank_ingest_matches_jax(tmp_path):
    """add_many (one codec batch) and add_from_files (the Python reader)
    against the JAX bank's subjects, bitwise: int32 labels, float32
    contrasts, the 4 distance and 3 registration channels stacked, ages, a
    trailing singleton frame squeezed, and the extent clamped to the
    bank."""
    rng = np.random.default_rng(1)
    subjects, ages = [], [31.5, None]
    for i, shape in enumerate([(18, 20, 17), (26, 22, 19)]):
        p = lambda n: str(tmp_path / f"s{i}_{n}")   # noqa: E731
        lab = rng.integers(0, 60, shape).astype(np.int32)
        paths = {"gen": _nifti(p("gen.nii.gz"), lab),
                 "seg": _nifti(p("seg.nii"), lab[::-1].copy()),
                 "T1": _nifti(p("t1.nii.gz"), (rng.random(shape) * 900)
                              .astype(np.int16), slope=0.5, inter=3.0),
                 "T2": _nifti(p("t2.nii"), rng.random(shape)[..., None]
                              .astype(np.float32), dims=[4, *shape, 1]),
                 "dist": [_nifti(p(f"d{c}.nii"), rng.random(shape)
                                 .astype(np.float32)) for c in range(4)],
                 "reg": [_nifti(p(f"r{c}.nii.gz"), rng.random(shape)
                                .astype(np.float32)) for c in range(3)]}
        subjects.append(paths)
    want = jengine.SubjectBank(BANK)
    want.add_many(subjects, ages=ages)
    many = engine.SubjectBank(BANK)
    assert many.add_many(subjects, ages=ages) == [0, 1]
    files = engine.SubjectBank(BANK)
    for paths, age in zip(subjects, ages):
        files.add_from_files(paths, age=age)
    for i in range(2):
        w = want.subjects[i]
        assert list(many.subjects[i]) == list(files.subjects[i]) == list(w)
        for k in w:
            a, b, c = (np.asarray(x.subjects[i][k])
                       for x in (many, files, want))
            assert _same(a, c) and _same(b, c), (i, k)
    assert many.subjects[1]["shape"].tolist() == [24, 22, 19]
    assert many.subjects[0]["gen"].base is None   # not a view of the arena
    bad = dict(subjects[0], T2=subjects[1]["T1"])
    for bank in (engine.SubjectBank(BANK),):
        with pytest.raises(ValueError, match="disagree on shape"):
            bank.add_many([bad])
        with pytest.raises(ValueError, match="disagree on shape"):
            bank.add_from_files(bad)


# ----------------------------------------------------------------- stream

@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return chip_smoke.write_subject_root(str(tmp_path_factory.mktemp("root")),
                                         EXTENT)


def _gen_cfg(attrdict, data_root, **generator):
    d, s = data_root
    return attrdict.from_nested({
        "data_root": d, "split_root": s, "split": "train",
        "dataset_names": ["HCP", "ATLAS"], "dataset_probs": [0.6, 0.4],
        "dataset_option": "brain_id", "lesion_resident": 1,
        "modality_probs": {"HCP": {"T1": 0.3, "T2": 0.6},
                           "ATLAS": {"T1": 0.5}},
        "generator": {"size": [16, 16, 16], "all_samples": 2,
                      "mild_samples": 1, **generator}})


class _SmallBank(jengine.SubjectBank):
    """The JAX datasets' bank at the test's bank shape (their bank is
    192^3)."""

    def __init__(self, bank_shape=None):
        super().__init__(BANK)


def _recording(monkeypatch, module, plan):
    """Replace `module.synth_item` by a recorder of (mode, lesion sum)."""
    def fake(*args, **kwargs):
        subject, mode = args[1], args[4]
        p = subject.get("pathol_prob")
        plan.append((mode, None if p is None else float(np.asarray(p).sum())))
        return {}, {}
    monkeypatch.setattr(module, "synth_item", fake)


def _wrap_get(monkeypatch, cls, plan):
    get = cls.get

    def wrapped(self, idx, *args, **kwargs):
        plan.append((self.name, idx))
        return get(self, idx, *args, **kwargs)
    monkeypatch.setattr(cls, "get", wrapped)


def test_stream_plan_matches_jax_over_two_epochs(monkeypatch, data_root):
    """build_datasets over the data root (the age task on: train_age.txt
    and the age table): the same subjects, bitwise, and ages; then over
    two epochs, and the grouped plan, the same datasets, subjects,
    modalities and lesion draws as the JAX ConcatStream."""
    tasks = ("T1", "segmentation", "pathology", "age")
    monkeypatch.setattr(jdatasets, "SubjectBank", _SmallBank)
    want = jdatasets.build_datasets(_gen_cfg(JAttrDict, data_root), tasks)
    got = datasets.build_datasets(_gen_cfg(AttrDict, data_root), tasks,
                                  device="cpu", bank_shape=BANK)
    assert list(got) == list(want) == ["HCP", "ATLAS", "_concat"]
    for n in ("HCP", "ATLAS"):
        assert len(got[n]) == len(want[n]) == 2
        assert got[n].input_prob == want[n].input_prob
        for a, b in zip(got[n].bank.subjects, want[n].bank.subjects):
            assert list(a) == list(b)
            assert all(_same(np.asarray(a[k]), np.asarray(b[k])) for k in b)
        assert [float(s["age"]) for s in got[n].bank.subjects] == \
            [float(s["age"]) for s in want[n].bank.subjects]
        assert list(got[n]._lesion_cache) == list(want[n]._lesion_cache)
        assert got[n]._lesion_paths == want[n]._lesion_paths
    plans = {"got": [], "want": []}
    _recording(monkeypatch, datasets, plans["got"])
    _recording(monkeypatch, jdatasets, plans["want"])
    _wrap_get(monkeypatch, datasets.SynthDataset, plans["got"])
    _wrap_get(monkeypatch, jdatasets.SynthDataset, plans["want"])
    key = jax.random.PRNGKey(0)
    for epoch in (0, 1):
        list(got["_concat"].epoch(epoch, 12, seed=0))
        list(want["_concat"].epoch(epoch, 12, key))
        assert list(got["_concat"].epoch_grouped(epoch, 4, 3)) == \
            list(want["_concat"].epoch_grouped(epoch, 4, 3))
    assert plans["got"] == plans["want"]
    assert {m for m, _ in plans["got"][1::2]} >= {"synth", "T1"}
    assert len({p for _, p in plans["got"][1::2]}) == 2   # both lesions
    # the grouped draw of per-rank synthesis: every modality first, then
    # the lesions in item order, as the JAX get_group
    for n in ("HCP", "ATLAS"):
        for idxs in ([0, 1], [1, 1, 0]):
            gs, gm = got[n].get_group(idxs)
            ws, wm = want[n].get_group(idxs)
            assert gm == wm
            assert (gs is None) == (ws is None)
            if gs is not None:
                assert sorted(gs[0]) == sorted(ws)
                for i, subj in enumerate(gs):
                    for k, v in subj.items():
                        assert _same(np.asarray(v), np.asarray(ws[k][i])), k


def test_stream_item_matches_jax(data_root):
    """One stream item (S=2, 16^3 from the 24^3 bank) with pathology
    forced on from the dataset's lesion pool (K1's plain version warps the
    lesion file), advected; the surface task integrates the inverse
    field. The JAX item takes its key, the port the JAX draws."""
    tasks = ("T1", "segmentation", "pathology", "surface")
    gen = dict(pathology_prob=1.0, random_shape_prob=0.0,
               augment_pathology=True)
    jds = jdatasets.SynthDataset(
        "ATLAS", _gen_cfg(JAttrDict, data_root, **gen), tasks,
        jdatasets.SynthStatic.from_cfg(_gen_cfg(JAttrDict, data_root,
                                                **gen)),
        bank_shape=BANK, input_prob={"T1": 0.5})
    tcfg = _gen_cfg(AttrDict, data_root, **gen)
    tds = datasets.SynthDataset("ATLAS", tcfg, tasks,
                                datasets.SynthStatic.from_cfg(tcfg),
                                bank_shape=BANK, input_prob={"T1": 0.5},
                                device="cpu")
    for ds in (jds, tds):
        ds.reseed(0)   # the roulette draws the real T1
    mode = choose_modality(copy.deepcopy(tds._rng), tds.input_prob,
                           set(tds.bank.subjects[1]))
    assert mode == "T1"
    key = jax.random.PRNGKey(4)   # nt 3: advected, non-empty
    jt, js = jds.get(1, key)
    knobs = {k: np.asarray(v) for k, v in jds._knobs[mode].items()}
    draws = jd.item_draws(key, jds.static, mode, knobs, BANK, tasks=tasks)
    with profiling.recording():
        tt, ts = tds.get(1, draws=draws)
    spans = {s.name for s in profiling.SPANS}
    assert "gen.lesion_warp" in spans and profiling.COUNTS["ode.steps"] > 0
    assert set(tt) == set(jt)
    assert {"surface_svf_neg", "surface_affine_A", "pathology_prob"} <= set(tt)
    p = tt["pathology"].numpy()
    assert p.sum() > 0
    assert np.mean(p == np.asarray(jt["pathology"])) >= MASK_AGREE
    for k in jt:
        if k == "segmentation":
            assert np.mean(tt[k].numpy().argmax(-1)
                           == np.asarray(jt[k]).argmax(-1)) >= SEG_AGREE
        elif k != "pathology":
            np.testing.assert_allclose(tt[k].numpy(), np.asarray(jt[k]),
                                       atol=TARGET_ATOL, err_msg=k)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   atol=TARGET_ATOL, err_msg=k)


# ----------------------------------------------------------- stream loop

def _stream_train(out_dir, data_root, n_epochs, resume=None):
    torch.manual_seed(0)
    cfg = joint_cfg(tload, size=(16, 16, 16))
    cfg.n_epochs, cfg.remat = n_epochs, False
    cfg.update({k: v for k, v in _gen_cfg(AttrDict, data_root).items()
                if k != "generator"})
    cfg.generator.all_samples, cfg.generator.mild_samples = 2, 1
    cfg, model = build_model(cfg, device="cpu")
    _, w, fn = make_criterion(cfg)
    ds = datasets.build_datasets(cfg, cfg.tasks, device="cpu",
                                 bank_shape=BANK)
    return loop.train(cfg, model, w, fn, None, str(out_dir),
                      itr_per_epoch=2, n_val_items=1, log_itr=1,
                      resume=resume, stream=ds["_concat"])


def _state_bytes(state):
    out = {f"p.{k}": v.numpy().tobytes()
           for k, v in state.model.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            out[f"o.{i}.{k}"] = v.numpy().tobytes()
    return out


def test_stream_train_resumes_bitwise(tmp_path, data_root):
    """train(stream=...) for 2 epochs x 2 iterations from the data root
    (subjects without distance or registration maps: those losses are
    left out): finite losses and validation across the datasets; a run
    stopped after epoch 0 and resumed from its checkpoint draws what the
    uninterrupted run draws and ends bitwise where it ends."""
    full = _stream_train(tmp_path / "full", data_root, 2)
    lines = [json.loads(s) for s in open(tmp_path / "full" / "log.txt")]
    assert [s["epoch"] for s in lines] == [0, 1]
    for s in lines:
        assert np.isfinite(s["train_loss_total"]) and s["train_skipped"] == 0
        assert np.isfinite(s["val_loss_total"])
        assert "train_loss_distance" not in s
    assert "val set spans datasets" in open(tmp_path / "full" /
                                            "train.log").read()
    _stream_train(tmp_path / "part", data_root, 1)
    resumed = _stream_train(tmp_path / "part", data_root, 2,
                            resume=str(tmp_path / "part" / "ckp" /
                                       "ckpt_000002"))
    assert resumed.step == full.step == 4
    assert _state_bytes(resumed) == _state_bytes(full)
    shutil.rmtree(tmp_path)
