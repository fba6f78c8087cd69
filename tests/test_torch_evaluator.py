"""The port's evaluator against the JAX package on the CPU: every metric at
fp64 (JAX under x64), the label one-hot and hemisphere lookups over ids
across [0, 9999], the file-pair protocol with every switch, and
Evaluator.eval on dicts of 3-D and 4-D outputs. Inputs from numpy seeds."""

import contextlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brainfm_tpu.models import evaluator as jev
from brainfm_tpu.utils.nifti import load_nifti, save_nifti
from brainfm_tpu_torch.models import evaluator as tev

# fp64 on both sides: sums (and SSIM's convolutions) in other orders
F64_RTOL = 1e-10
# fp32 on both sides (the JAX package casts to fp32): sums over the volume
# in other orders
F32_RTOL = 1e-6
# eval_files' scores: as F32_RTOL, but normalized_l2 squares the residual
# w * pred - target, whose fp32 scale w differs in its last bits between
# the two sums, and reads 6e-6 apart on these files
FILE_RTOL = 1e-5


@contextlib.contextmanager
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def vols(seed, shape=(20, 22, 18)):
    rng = np.random.default_rng(seed)
    x = rng.random(shape) * 3.0
    y = x + 0.3 * rng.standard_normal(shape)
    return x, y


@pytest.mark.parametrize("name", ["l1", "psnr", "ssim", "normalized_l2",
                                  "corrected_l1", "raw_ssim", "l1_masked",
                                  "psnr_range"])
def test_metric_matches_jax_fp64(name):
    x, y = vols(len(name))
    fn = {"raw_ssim": "ssim", "l1_masked": "l1", "psnr_range": "psnr"}
    kw = {}
    if name == "l1_masked":
        kw = {"mask": (np.random.default_rng(1).random(x.shape) > 0.4)
              .astype(np.float64)}
    if name == "psnr_range":
        kw = {"data_range": 2.5}
    t_fn = getattr(tev, fn[name]) if name in fn else tev.METRIC_MAP[name]
    j_fn = getattr(jev, fn[name]) if name in fn else jev.METRIC_MAP[name]
    got = t_fn(torch.from_numpy(x), torch.from_numpy(y),
               **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
                  for k, v in kw.items()})
    with x64():
        want = j_fn(jnp.asarray(x), jnp.asarray(y), **kw)
    assert got.dtype == torch.float64
    assert rel(got, want) <= F64_RTOL, (float(got), float(want))


def test_ssim_cs_and_ms_ssim_match_jax_fp64():
    """ms_ssim at the JAX package's own test size (48^3, two weights),
    raw and normalized, and ssim's contrast-structure term."""
    x, y = vols(3, (48, 48, 48))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    with x64():
        jx, jy = jnp.asarray(x), jnp.asarray(y)
        for got, want in (
                (tev.ms_ssim(tx, ty, 3.0, weights=(0.4, 0.6)),
                 jev.ms_ssim(jx, jy, 3.0, weights=(0.4, 0.6))),
                (tev.ms_ssim_normalized(tx, ty, weights=(0.5, 0.5)),
                 jev.ms_ssim_normalized(jx, jy, weights=(0.5, 0.5))),
                (tev.ssim(tx, ty, return_cs=True)[1],
                 jev.ssim(jx, jy, return_cs=True)[1])):
            assert rel(got, want) <= F64_RTOL, (float(got), float(want))


def test_dice_and_seg_dice_match_jax():
    rng = np.random.default_rng(4)
    p = rng.integers(0, 5, (12, 13, 11))
    t = np.where(rng.random(p.shape) < 0.8, p, rng.integers(0, 5, p.shape))
    labels = [0, 1, 2, 3, 4, 9]
    got = tev.seg_dice(torch.from_numpy(p), torch.from_numpy(t), labels)
    want = jev.seg_dice(jnp.asarray(p), jnp.asarray(t), labels)
    # fp32 in both packages (exact counts; the mean in another order)
    assert rel(got, want) <= F32_RTOL
    po = np.eye(5)[p][None]
    to = np.eye(5)[t][None]
    with x64():
        want = np.asarray(jev.dice(jnp.asarray(po), jnp.asarray(to)))
    got = tev.dice(torch.from_numpy(po), torch.from_numpy(to)).numpy()
    np.testing.assert_allclose(got, want, rtol=F64_RTOL)


def _labels(seed, shape=(10, 12, 9)):
    """Label ids across [0, 9999]: evaluation and left-hemisphere labels,
    ids in neither list, 0 and 9999."""
    rng = np.random.default_rng(seed)
    pool = np.array(sorted(set(jev.EVAL_LABELS) | set(jev.LEFT_HEMIS_LABELS)
                           | {5, 99, 1000, 4242, 9998, 9999}), np.int32)
    lab = rng.choice(pool, shape).astype(np.int32)
    lab.flat[:2] = (0, 9999)
    return lab


def test_label_onehot_and_hemis_mask_match_jax_exactly():
    lab = _labels(5)
    for labels in (None, [0, 2, 3, 41, 9999]):
        got = tev.label_onehot(torch.from_numpy(lab), labels)
        want = np.asarray(jev.label_onehot(lab, labels))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    regx = np.random.default_rng(6).standard_normal(lab.shape).astype(
        np.float32)
    got = tev.hemis_mask_from(torch.from_numpy(lab), torch.from_numpy(regx))
    np.testing.assert_array_equal(got.numpy(), jev.hemis_mask_from(lab, regx))
    assert tev.LEFT_HEMIS_LABELS == list(jev.LEFT_HEMIS_LABELS)
    assert tev.EVAL_LABELS == jev.EVAL_LABELS
    assert tev.N_NEUTRAL_EVAL == jev.N_NEUTRAL_EVAL
    # outside [0, 9999] K2 and its plain version give index 0 (background)
    odd = torch.tensor([[[-3, 10000, 2]]], dtype=torch.int32)
    assert tev.label_onehot(odd)[..., 0].tolist() == [1.0, 1.0, 0.0]


def test_align_shape_and_path_stem_match_jax():
    a, b = np.zeros((5, 6, 7)), np.ones((6, 4, 7))
    ta, tb = tev.align_shape(torch.from_numpy(a), torch.from_numpy(b))
    ja, jb = jev.align_shape(a, b)
    assert tuple(ta.shape) == ja.shape and tuple(tb.shape) == jb.shape
    for p in ("./x.nii.gz", "out.v2/x.nii", "a/b.mgz", "c"):
        assert tev.path_stem(p) == jev.path_stem(p)


def _pairs(tmp):
    """Files of a segmentation pair and an image pair, each prediction
    larger than its target (the shape mismatch)."""
    rng = np.random.default_rng(7)
    t = rng.choice(jev.EVAL_LABELS[:9], (14, 12, 12)).astype(np.int32)
    p = np.where(rng.random(t.shape) < 0.85, t,
                 rng.choice(jev.EVAL_LABELS[:9], t.shape)).astype(np.float32)
    p = p + rng.uniform(-0.3, 0.3, p.shape).astype(np.float32)  # rint
    save_nifti(os.path.join(tmp, "pred.label.nii.gz"),
               np.pad(p, ((0, 2), (0, 1), (0, 0))))
    save_nifti(os.path.join(tmp, "gt.label.nii.gz"), t)
    it = (rng.random((14, 12, 12)) * 2 - 0.2).astype(np.float32)
    ip = (it + 0.2 * rng.standard_normal(it.shape)).astype(np.float32)
    it[0] = 0.0
    save_nifti(os.path.join(tmp, "pred.nii.gz"),
               np.pad(ip, ((0, 1), (0, 0), (0, 2))))
    save_nifti(os.path.join(tmp, "gt.nii.gz"), it)
    return t.shape


@pytest.mark.parametrize("switches", [
    {}, {"flip": True}, {"kill_target_labels": [2, 77]},
    {"add_mask": True}, {"normalize": True}, {"clamp": True},
    {"hemis_mask": True}, {"is_seg": False},
    {"flip": True, "add_mask": True, "normalize": True, "clamp": True}])
def test_eval_files_matches_jax(tmp_path, switches):
    shape = _pairs(str(tmp_path))
    kw = dict(switches)
    if kw.pop("hemis_mask", False):
        kw["hemis_mask"] = (np.random.default_rng(8).random(shape) > 0.3
                            ).astype(np.float32)
    for pred, gt, metrics in (
            ("pred.label", "gt.label", ["seg_dice", "seg_l1"]),
            ("pred", "gt", ["recon_l1", "recon_psnr", "recon_ssim",
                            "bf_normalized_l2", "sr_corrected_l1"])):
        tev_ = tev.Evaluator(metrics, device="cpu")
        jev_ = jev.Evaluator(metrics)
        p = str(tmp_path / f"{pred}.nii.gz")
        g = str(tmp_path / f"{gt}.nii.gz")
        t_kw = dict(kw)
        if "hemis_mask" in kw:
            t_kw["hemis_mask"] = torch.from_numpy(kw["hemis_mask"])
        got = tev_.eval_files(p, g, **t_kw)
        masked = p.replace(".nii.gz", "_masked.nii.gz")
        got_masked = (load_nifti(masked)[0] if os.path.isfile(masked)
                      else None)
        if got_masked is not None:
            os.remove(masked)
        want = jev_.eval_files(p, g, **kw)
        assert got.keys() == want.keys()
        for k in want:
            tol = FILE_RTOL if k.endswith("normalized_l2") else F32_RTOL
            assert rel(got[k], want[k]) <= tol or \
                abs(got[k] - want[k]) <= tol, (k, got[k], want[k])
        if kw.get("add_mask"):
            np.testing.assert_array_equal(got_masked, load_nifti(masked)[0])
        else:
            assert got_masked is None


def test_evaluator_eval_on_dicts_matches_jax():
    """Multi-token metric names, dice on label maps, 3-D outputs and 4-D
    (S, D, H, W) outputs scored per sample against 3-D and 4-D targets,
    at fp64."""
    rng = np.random.default_rng(9)
    shp = (16, 15, 14)
    lab = rng.choice(jev.EVAL_LABELS[:6], shp)
    lab2 = np.where(rng.random(shp) < 0.9, lab, 0)
    t1 = rng.random(shp)
    out = {"label": lab2[..., None], "T1": (t1 + 0.1 * rng.random(shp))[None],
           "high_res": np.stack([t1 * 0.9, t1 * 1.1])[..., None],
           "bias_field": np.stack([t1 + 0.2, t1 - 0.1])}
    tgt = {"label": lab, "T1": t1, "high_res": t1,
           "bias_field": np.stack([t1, t1])}
    metrics = ["seg_dice", "recon_psnr", "recon_ssim", "sr_ssim",
               "sr_l1", "bf_normalized_l2", "bf_ssim", "pathol_dice",
               "feat_corrected_l1"]
    with x64():
        want = jev.Evaluator(metrics).eval(out, tgt)
    got = tev.Evaluator(metrics, device="cpu").eval(
        {k: torch.from_numpy(v) for k, v in out.items()},
        {k: torch.from_numpy(v) for k, v in tgt.items()})
    assert got.keys() == want.keys()
    assert "pathol_dice" not in got
    for k in want:
        tol = F32_RTOL if k == "seg_dice" else F64_RTOL
        assert rel(got[k], want[k]) <= tol, (k, got[k], want[k])
