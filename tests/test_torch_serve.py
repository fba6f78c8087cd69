"""The port's serving slice against the JAX package on the CPU: NIfTI and
MGH I/O, RAS alignment, the zoom family, prepare_image, postprocess, the
tile walk, the Inferencer's entry points, evaluate_path's three pipelines,
the deformed atlas, .pth checkpoints and the CLI twins. Small models
(f_maps 8, 3 levels) on 24-40^3 volumes; inputs from numpy seeds, weights
from the JAX Inferencer's params through `from_jax_params`."""

import contextlib
import gzip
import importlib.util
import itertools
import os
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from brainfm_tpu.config import AttrDict as JAttrDict
from brainfm_tpu.infer import api as japi
from brainfm_tpu.infer import prepare as jprep
from brainfm_tpu.infer import tiles as jtiles
from brainfm_tpu.models import build as jbuild
from brainfm_tpu.ops import resize as jresize
from brainfm_tpu.train import step as jstep
from brainfm_tpu.train.checkpoint import save_checkpoint as jsave
from brainfm_tpu.utils import nifti as jnifti
from brainfm_tpu.utils import orientation as jorient
from brainfm_tpu_torch.config import AttrDict
from brainfm_tpu_torch.infer import api, prepare, tiles
from brainfm_tpu_torch.models import build, from_jax_params, load_pth
from brainfm_tpu_torch.ops import resize
from brainfm_tpu_torch.utils import nifti, orientation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

TASKS = ("T1", "CT", "segmentation", "distance", "bias_field",
         "registration", "super_resolution")
# fp32 on both sides: matrix products and convolutions summed in other
# orders; values normalized to [0, 1] or O(1)
F32_ATOL = 1e-5
# fp64 on both sides: only summation order differs
F64_ATOL = 1e-9
# files are written as float32: the fp64 outputs of the two packages round
# to the same float32 or to neighbours
FILE_RTOL = 1e-6
# fp32 models on both sides, relative to the largest |output| (at least 1):
# convolutions and GroupNorm statistics summed in other orders
F32_MODEL_RTOL = 1e-4
# fp32 softmaxes that differ in the last bits can flip a near-tied argmax
LABEL_AGREE_F32 = 0.999


@contextlib.contextmanager
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def cfg_dict(left=False, tasks=TASKS):
    return dict(task={t: True for t in tasks},
                generator={"left_hemis_only": left, "size": [32, 32, 32]},
                losses={"uncertainty": None}, backbone="unet3d", f_maps=8,
                num_levels=3, num_groups=8, layer_order="gcl",
                unit_feat=False, task_f_maps=[8], max_surf_distance=3.0)


def head_file(path, shape, voxel_mm, seed, axes=chip_smoke.SERVE_AXES):
    vol = chip_smoke.procedural_head(shape, voxel_mm, seed, "cpu")
    nifti.save_nifti(path, vol, chip_smoke.serve_affine(shape, voxel_mm,
                                                        axes))
    return path


@pytest.fixture(scope="module")
def pair():
    """(JAX Inferencer, port Inferencer) at fp64 with the same weights."""
    with x64():
        jinf = japi.Inferencer(JAttrDict.from_nested(cfg_dict()),
                               compute_dtype=jnp.float64)
        jinf.params = jax.tree.map(lambda a: np.asarray(a, np.float64),
                                   jinf.params)
    tinf = api.Inferencer(AttrDict.from_nested(cfg_dict()),
                          compute_dtype=torch.float64, device="cpu")
    tinf.model.load_state_dict(from_jax_params(jinf.params))
    return jinf, tinf


# ---------------------------------------------------------------- NIfTI I/O


def _qform_scaled(path, data):
    """A NIfTI-1 file with a qform affine (sform_code 0, qfac -1) and
    scl_slope 2, scl_inter 0.5, patched into a written header."""
    nifti.save_nifti(path, data, np.eye(4))
    with open(path, "r+b") as f:
        hdr = bytearray(f.read(352))
        struct.pack_into("<f", hdr, 76, -1.0)               # qfac
        struct.pack_into("<3f", hdr, 80, 1.2, 0.9, 1.5)     # pixdim 1-3
        struct.pack_into("<2f", hdr, 112, 2.0, 0.5)         # slope, inter
        struct.pack_into("<2h", hdr, 252, 1, 0)             # qform, sform
        struct.pack_into("<6f", hdr, 256, 0.1, -0.2, 0.3, 4.0, -5.0, 6.0)
        f.seek(0)
        f.write(hdr)


@pytest.mark.parametrize("ext", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int16])
def test_nifti_roundtrip_between_packages(tmp_path, ext, dtype):
    rng = np.random.default_rng(0)
    data = (rng.standard_normal((7, 6, 5)) * 100).astype(dtype)
    aff = chip_smoke.serve_affine((7, 6, 5), (1.2, 1.0, 1.5))
    for write, read, tag in ((nifti.save_nifti, jnifti.load_nifti, "t2j"),
                             (jnifti.save_nifti, nifti.load_nifti, "j2t")):
        p = str(tmp_path / f"{tag}{ext}")
        write(p, data, aff)
        got, gaff = read(p)
        assert got.dtype == data.dtype
        np.testing.assert_array_equal(got, data)
        np.testing.assert_allclose(gaff, aff, atol=1e-6)
    opener = gzip.open if ext.endswith(".gz") else open
    with opener(str(tmp_path / f"t2j{ext}"), "rb") as a, \
            opener(str(tmp_path / f"j2t{ext}"), "rb") as b:
        assert a.read() == b.read()
    # MRIwrite / MRIread and viewVolume
    p = str(tmp_path / f"mri{ext}")
    nifti.MRIwrite(data, aff, p, dtype=np.float32)
    for rd in (nifti.MRIread, jnifti.MRIread):
        v, a2 = rd(p)
        np.testing.assert_array_equal(v, data.astype(np.float32))
        np.testing.assert_allclose(a2, aff, atol=1e-6)
    out = nifti.viewVolume(data, aff, names=["v"], ext=ext,
                           save_dir=str(tmp_path / "view"))
    np.testing.assert_array_equal(jnifti.MRIread(out[0], im_only=True),
                                  data.astype(np.float32))


def test_nifti_qform_and_scaling_read_alike(tmp_path):
    p = str(tmp_path / "q.nii")
    data = np.arange(60, dtype=np.int16).reshape(5, 4, 3)
    _qform_scaled(p, data)
    got, aff = nifti.load_nifti(p)
    want, waff = jnifti.load_nifti(p)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data * 2.0 + 0.5)
    np.testing.assert_array_equal(aff, waff)
    # the quaternion rotates (not diagonal) and qfac -1 makes it improper
    assert not np.allclose(aff[:3, :3], np.diag(np.diag(aff[:3, :3])))
    assert np.linalg.det(aff[:3, :3]) < 0
    np.testing.assert_allclose(aff[:3, 3], [4.0, -5.0, 6.0])


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_mgz_read_alike(tmp_path, dtype):
    rng = np.random.default_rng(1)
    vol = (rng.random((9, 8, 7)) * 50).astype(dtype)
    p = str(tmp_path / "a.mgz")
    mdc = chip_smoke.SERVE_AXES
    chip_smoke.write_mgz(p, vol, (1.0, 2.0, 0.5), mdc, (3.0, -4.0, 5.0))
    got, aff = nifti.load_nifti(p)
    want, waff = jnifti.load_nifti(p)
    np.testing.assert_array_equal(got, vol)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(aff, waff)
    np.testing.assert_allclose(aff[:3, :3], mdc * [1.0, 2.0, 0.5])
    np.testing.assert_allclose(aff[:3, :3] @ [4.5, 4.0, 3.5] + aff[:3, 3],
                               [3.0, -4.0, 5.0], atol=1e-5)


# -------------------------------------------------------------- orientation


def test_align_volume_to_ref_all_signed_permutations():
    vol = np.random.default_rng(2).random((4, 5, 6))
    n = 0
    for perm in itertools.permutations(range(3)):
        for signs in itertools.product((1, -1), repeat=3):
            axes = np.zeros((3, 3))
            for j, (i, s) in enumerate(zip(perm, signs)):
                axes[i, j] = s
            aff = chip_smoke.serve_affine(vol.shape, (1.1, 0.9, 1.3), axes)
            got, gaff = orientation.align_volume_to_ref(vol, aff,
                                                        return_aff=True)
            want, waff = jorient.align_volume_to_ref(vol, aff,
                                                     return_aff=True)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(gaff, waff)
            np.testing.assert_array_equal(orientation.get_ras_axes(aff),
                                          jorient.get_ras_axes(aff))
            # RAS after alignment: a positive diagonal
            assert (np.diag(gaff)[:3] > 0).all()
            n += 1
    assert n == 48


# ------------------------------------------------------------------- resize


@pytest.mark.parametrize("res", [0.8, 1.0, 1.2])
def test_zoom_family_matches_jax(res):
    rng = np.random.default_rng(3)
    x = rng.random((12, 11, 10, 2)).astype(np.float32)
    tx = torch.from_numpy(x)
    f = (res, 1.0 / res, 1.1)
    np.testing.assert_allclose(resize.myzoom(tx, f).numpy(),
                               np.asarray(jresize.myzoom(jnp.asarray(x), f)),
                               atol=F32_ATOL)
    aff = chip_smoke.serve_affine((12, 11, 10), (res, 1.0, 1.3))
    got, gaff = resize.myzoom_anisotropic(tx, (9, 13, 10), aff)
    want, waff = jresize.myzoom_anisotropic(jnp.asarray(x), (9, 13, 10), aff)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)
    np.testing.assert_allclose(gaff, waff, atol=1e-12)
    for vol in (x, x[..., 0]):
        got, gaff = resize.volume_resize(torch.from_numpy(vol), aff, 1.0)
        want, waff = jresize.volume_resize(jnp.asarray(vol), aff, 1.0)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=F32_ATOL)
        np.testing.assert_allclose(gaff, waff, atol=1e-12)


# ------------------------------------------------------------ prepare_image


PREP_CASES = {
    "plain": {},
    "CT": {"is_CT": True},
    "label": {"is_label": True},
    "zero_crop": {"zero_crop_first": True},
    "bias_field": {"add_bf": True, "bf_seed": 3},
    "spacing": {"spacing": (1.5, 2.0, 3.0)},
}


@pytest.mark.parametrize("case", list(PREP_CASES))
@pytest.mark.parametrize("voxel", [(1.0, 1.0, 1.0), (1.2, 1.0, 1.5)])
def test_prepare_image_matches_jax(tmp_path, case, voxel):
    """A head file with a permuted and flipped affine; image, affine,
    crop_start and orig_shp as the JAX package gives them (fp32)."""
    kw = PREP_CASES[case]
    p = head_file(str(tmp_path / "h.nii.gz"), (30, 36, 24), voxel, seed=4)
    if case == "label":
        v, a = nifti.load_nifti(p)
        nifti.save_nifti(p, (v / 20).astype(np.int32), a)
    got = prepare.prepare_image(p, [32, 32, 32], device="cpu", **kw)
    want = jprep.prepare_image(p, [32, 32, 32], **kw)
    assert got[0].device.type == "cpu"
    assert tuple(got[0].shape) == want[0].shape
    if case == "label" and voxel == (1.0, 1.0, 1.0):
        assert got[0].dtype == torch.int32
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    else:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=F32_ATOL)
    np.testing.assert_allclose(got[1], want[1], atol=1e-9)
    assert list(got[2]) == list(want[2])
    assert tuple(got[3]) == tuple(want[3])


@pytest.mark.parametrize("perm,signs", [((0, 1, 2), (1, 1, 1)),
                                        ((2, 0, 1), (-1, 1, -1)),
                                        ((1, 2, 0), (1, -1, 1)),
                                        ((0, 2, 1), (-1, -1, -1))])
def test_prepare_image_orientations_match_jax(tmp_path, perm, signs):
    """The RAS swaps and flips, done on the tensor from
    `ras_reorientation`, against the JAX package's numpy alignment, with
    a crop on every axis (40 > 32) and without one (win_size None)."""
    axes = np.zeros((3, 3))
    for j, (i, s) in enumerate(zip(perm, signs)):
        axes[i, j] = s
    p = head_file(str(tmp_path / "o.nii"), (40, 34, 37), (1.0, 1.0, 1.0),
                  seed=17, axes=axes)
    for win in ([32, 32, 32], None):
        got = prepare.prepare_image(p, win, device="cpu")
        want = jprep.prepare_image(p, win)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1], want[1], atol=1e-9)
        assert list(got[2]) == list(want[2])
        assert tuple(got[3]) == tuple(want[3])
        assert got[0].is_contiguous()


def test_bias_field_and_roundtrip_match_jax():
    im = np.random.default_rng(5).random((20, 22, 18)).astype(np.float32)
    got, gbf = prepare.add_bias_field(torch.from_numpy(im), seed=7)
    want, wbf = jprep.add_bias_field(jnp.asarray(im), seed=7)
    np.testing.assert_allclose(gbf.numpy(), np.asarray(wbf), rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(
        prepare.resample_roundtrip(torch.from_numpy(im), (2.0, 1.5, 3.0))
        .numpy(),
        np.asarray(jprep.resample_roundtrip(jnp.asarray(im), (2.0, 1.5, 3.0))),
        atol=F32_ATOL)


# -------------------------------------------------------------- postprocess


def _raw_outputs(cfg, rng, shape=(2, 6, 7, 5)):
    return {k: rng.standard_normal(shape + (c,)) for k, c in
            cfg.out_channels.items()}


@pytest.mark.parametrize("left", [False, True])
def test_postprocess_matches_jax(left):
    """Every branch at fp64: SR residual + input, bias exp, distance split
    and fake-cortical render, registration split, labels (K2's plain
    version here), CT x1000."""
    rng = np.random.default_rng(6)
    tcfg = build.process_args(AttrDict.from_nested(cfg_dict(left)))
    jcfg = jbuild.process_args(JAttrDict.from_nested(cfg_dict(left)))
    raw = _raw_outputs(tcfg, rng)
    x = rng.standard_normal((2, 6, 7, 5, 1))
    with x64():
        want = jbuild.postprocess({k: jnp.asarray(v) for k, v in raw.items()},
                                  jcfg, samples={"input": jnp.asarray(x)})
        want = {k: np.asarray(v) for k, v in want.items()}
    got = build.postprocess({k: torch.from_numpy(v) for k, v in raw.items()},
                            tcfg, samples={"input": torch.from_numpy(x)})
    assert set(got) == set(want)
    assert ("rp" in got) == (not left)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        if k == "label":
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), want[k])
        else:
            np.testing.assert_allclose(got[k].numpy(), want[k],
                                       atol=F64_ATOL, err_msg=k)


def test_postprocess_lifts_bf16_to_fp32():
    rng = np.random.default_rng(7)
    tcfg = build.process_args(AttrDict.from_nested(cfg_dict()))
    raw = {k: torch.from_numpy(v).float() for k, v in
           _raw_outputs(tcfg, rng).items()}
    x = torch.from_numpy(rng.standard_normal((2, 6, 7, 5, 1))).float()
    want = build.postprocess(raw, tcfg, samples={"input": x})
    got = build.postprocess({k: v.bfloat16() for k, v in raw.items()}, tcfg,
                            samples={"input": x.bfloat16()})
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k
        assert v.dtype in (torch.float32, torch.int32), k


# -------------------------------------------------------------------- tiles


@pytest.mark.parametrize("shape,stride,win", [
    ((40, 36, 33), (8, 8, 8), (16, 16, 16)),
    ((220, 220, 220), (80, 80, 80), (160, 160, 160)),
    ((20, 50, 17), (10, 30, 4), (24, 32, 8))])
def test_tile_plan_matches_jax(shape, stride, win):
    tiles_t, cnt_t = tiles.tile_plan(shape, stride, win)
    tiles_j, cnt_j = jtiles.tile_plan(shape, stride, win)
    assert tiles_t == tiles_j
    np.testing.assert_array_equal(cnt_t, cnt_j)
    if shape == (220, 220, 220):
        assert len(tiles_t) == 8


def test_tiled_apply_exact_on_a_pointwise_op():
    """Integer values: every overlap sum and its division by the count is
    exact in the fp32 canvases, so the blend returns the op's values."""
    vol = torch.from_numpy(np.random.default_rng(8).integers(
        -1000, 1000, (20, 17, 23)).astype(np.float32))
    out = tiles.tiled_apply(
        lambda p, t: {"a": t * p, "b": torch.cat([t, -t], dim=-1)}, 3.0, vol,
        stride=(6, 5, 7), win_size=(10, 9, 12))
    assert torch.equal(out["a"], 3.0 * vol[..., None])
    assert torch.equal(out["b"], torch.stack([vol, -vol], -1))
    assert out["a"].dtype == torch.float32


def test_evaluate_tiled_matches_jax(pair):
    """fp32 models (the JAX package's fused tile scan does not run under
    x64) with fp32 canvases, blended in the same tile order."""
    jinf, _ = pair
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), jinf.params)
    j32 = japi.Inferencer(JAttrDict.from_nested(cfg_dict()))
    j32.params = params
    t32 = api.Inferencer(AttrDict.from_nested(cfg_dict()), device="cpu")
    t32.model.load_state_dict(from_jax_params(params))
    vol = np.random.default_rng(9).random((28, 24, 26)).astype(np.float32)
    want = j32.evaluate_tiled(jnp.asarray(vol), (8, 8, 8), (16, 16, 16),
                              accum_dtype=jnp.float32)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = t32.evaluate_tiled(vol, (8, 8, 8), (16, 16, 16))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        if k == "label":
            agree = np.mean(got[k].numpy() == want[k])
            assert agree >= LABEL_AGREE_F32, agree
        else:
            scale = max(np.abs(want[k]).max(), 1.0)
            np.testing.assert_allclose(got[k].numpy() / scale,
                                       want[k] / scale, atol=F32_MODEL_RTOL,
                                       err_msg=k)


# --------------------------------------------------------------- Inferencer


def test_evaluate_image_matches_jax(pair):
    jinf, tinf = pair
    vol = np.random.default_rng(10).random((24, 20, 28))
    with x64():
        want = jinf.evaluate_image(vol)
        want = {k: v if k == "feat" else np.asarray(v)
                for k, v in want.items()}
        wfeat = np.asarray(jinf.evaluate_image(vol, feature_only=True))
    got = tinf.evaluate_image(vol)
    assert set(got) == set(want)
    assert {"label", "fake_cortical", "regx", "high_res", "bias_field",
            "rw"} <= set(got)
    for k in want:
        if k == "feat":
            assert len(got[k]) == len(want[k]) == 3
            for a, b in zip(got[k], want[k]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=F64_ATOL)
        elif k == "label":
            np.testing.assert_array_equal(got[k].numpy(), want[k])
        else:
            np.testing.assert_allclose(got[k].numpy(), want[k],
                                       atol=F64_ATOL, err_msg=k)
    # keep_feat=False drops only the pyramid; feature_only overrides it
    slim = tinf.evaluate_image(vol, keep_feat=False)
    assert set(slim) == set(got) - {"feat"}
    for k in slim:
        assert torch.equal(slim[k], got[k]), k
    f = tinf.evaluate_image(vol, feature_only=True, keep_feat=False)
    np.testing.assert_allclose(f.numpy(), wfeat, atol=F64_ATOL)
    raw = tinf.evaluate_image(vol, run_postprocess=False)
    assert "segmentation" in raw and "label" not in raw


def test_evaluate_batch_matches_per_volume(pair):
    _, tinf = pair
    vols = np.random.default_rng(11).random((3, 16, 20, 16))
    b = tinf.evaluate_batch(vols)
    assert "feat" not in b
    for i in range(3):
        one = tinf.evaluate_image(vols[i], keep_feat=False)
        for k in one:
            np.testing.assert_allclose(b[k][i:i + 1].numpy(),
                                       one[k].numpy(), atol=F64_ATOL,
                                       err_msg=f"{k}[{i}]")
    with pytest.raises(ValueError):
        tinf.evaluate_batch(np.zeros((4, 4, 4)))


def _tree_files(d):
    return {f: nifti.load_nifti(os.path.join(d, f))[0]
            for f in sorted(os.listdir(d))}


def test_evaluate_path_pipelines_match_jax(tmp_path, pair, monkeypatch):
    """Serial, prefetch and batched (groups of 2, mixed shapes: 24^3 is
    kept, 40^3 cropped to 32^3) write the same files as each other and as
    the JAX package's evaluate_path. The JAX model computes partly in fp32
    when its input is fp32, as prepare_image returns it, so the JAX side is
    handed the prepared image in fp64 here (a test-side wrapper): both then
    run in fp64."""
    jinf, tinf = pair

    def prepare64(*a, **k):
        im, *rest = jprep.prepare_image(*a, **k)
        return (jnp.asarray(im, jnp.float64), *rest)

    monkeypatch.setattr(japi, "prepare_image", prepare64)
    rng = np.random.default_rng(12)
    paths = []
    for i, side in enumerate((24, 40, 24)):
        p = str(tmp_path / f"vol{i}.nii.gz")
        nifti.save_nifti(p, rng.random((side,) * 3, dtype=np.float32),
                         chip_smoke.serve_affine((side,) * 3, (1, 1, 1)))
        paths.append(p)
    kw = dict(win_size=(32, 32, 32), exclude_keys=("segmentation",))
    with x64():
        d_jax = jinf.evaluate_path(paths, str(tmp_path / "jax"),
                                   prefetch=False, **kw)
    d_ser = tinf.evaluate_path(paths, str(tmp_path / "serial"),
                               prefetch=False, save_input=True, **kw)
    d_pre = tinf.evaluate_path(paths, str(tmp_path / "prefetch"), **kw)
    d_bat = tinf.evaluate_path(paths, str(tmp_path / "batched"),
                               batch_size=2, **kw)
    d_bnp = tinf.evaluate_path(paths, str(tmp_path / "batched_nopf"),
                               batch_size=2, prefetch=False, **kw)
    assert [os.path.basename(d) for d in d_ser] == ["vol0", "vol1", "vol2"]
    for i in range(3):
        want = _tree_files(d_jax[i])
        ser = _tree_files(d_ser[i])
        assert set(ser) == set(want) | {"input.nii.gz"}
        assert "out_label.nii.gz" in want
        assert "out_segmentation.nii.gz" not in want
        for d in (d_pre, d_bat, d_bnp):
            got = _tree_files(d[i])
            assert set(got) == set(want)
            for f in want:
                np.testing.assert_array_equal(got[f], ser[f], err_msg=f)
        for f in want:
            np.testing.assert_allclose(ser[f], want[f], rtol=FILE_RTOL,
                                       atol=1e-7, err_msg=f)
        assert (ser["out_T1.nii.gz"] >= 0).all()     # clipped at 0
        assert (ser["out_regx.nii.gz"] < 0).any()    # not clipped


def test_get_deformed_atlas_matches_jax(tmp_path):
    """An in-test atlas (.mgz, 2 mm, oblique-free but offset); fp32
    coordinates and warp on both sides."""
    rng = np.random.default_rng(13)
    atlas = chip_smoke.procedural_atlas((40, 44, 36), seed=1, dev="cpu")
    p = str(tmp_path / "atlas.mgz")
    chip_smoke.write_mgz(p, atlas, (2.0, 2.0, 2.0), np.eye(3), (3, -2, 1))
    shp = (18, 20, 16)
    reg = [rng.uniform(-0.3, 0.3, shp).astype(np.float32) for _ in range(3)]
    labels = rng.integers(0, 3, shp).astype(np.int32)
    want = np.asarray(japi.get_deformed_atlas(
        jnp.asarray(labels), *[jnp.asarray(r) for r in reg], atlas_path=p))
    got = api.get_deformed_atlas(torch.from_numpy(labels),
                                 *[torch.from_numpy(r) for r in reg],
                                 atlas_path=p)
    assert got.dtype == torch.float32 and tuple(got.shape) == shp
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)
    assert (got.numpy()[labels == 0] == 0).all()
    assert (got.numpy()[labels > 0] > 0).mean() > 0.3


def test_default_atlas_path(monkeypatch):
    monkeypatch.delenv("BRAINFM_ATLAS_PATH", raising=False)
    assert api.default_atlas_path() == os.path.join(ROOT, "files", "gca.mgz")
    monkeypatch.setenv("BRAINFM_ATLAS_PATH", "/x/env.mgz")
    assert api.default_atlas_path() == "/x/env.mgz"
    assert api.default_atlas_path(AttrDict(atlas_path="/x/c.mgz")) \
        == "/x/c.mgz"


@pytest.mark.parametrize("wrap", ["model_module", "bare_backbone"])
def test_pth_checkpoint_served_by_both(tmp_path, pair, wrap):
    """A reference-style checkpoint ({"model": {"module." + k: v}}) loads
    into both Inferencers and serves the same outputs (fp64); a bare
    backbone state dict loads into the port's backbone."""
    jinf, _ = pair
    sd = {k: v.float() for k, v in from_jax_params(jinf.params).items()}
    vol = np.random.default_rng(14).random((16, 16, 16))
    p = str(tmp_path / "m.pth")
    if wrap == "bare_backbone":
        bb = {k[len("backbone."):]: v for k, v in sd.items()
              if k.startswith("backbone.")}
        torch.save(bb, p)
        t = api.Inferencer(AttrDict.from_nested(cfg_dict()), ckpt_path=p,
                           compute_dtype=torch.float64, device="cpu")
        for k, v in bb.items():
            assert torch.equal(t.model.backbone.state_dict()[k],
                               v.double()), k
        return
    torch.save({"model": {"module." + k: v for k, v in sd.items()},
                "epoch": 3}, p)
    with x64():
        j = japi.Inferencer(JAttrDict.from_nested(cfg_dict()), ckpt_path=p,
                            compute_dtype=jnp.float64)
        want = {k: np.asarray(v) for k, v in
                j.evaluate_image(vol, keep_feat=False).items()}
    t = api.Inferencer(AttrDict.from_nested(cfg_dict()), ckpt_path=p,
                       compute_dtype=torch.float64, device="cpu")
    got = t.evaluate_image(vol, keep_feat=False)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=F64_ATOL,
                                   err_msg=k)
    with pytest.raises(RuntimeError):
        bad = str(tmp_path / "bad.pth")
        torch.save({"model": {"head.extra.weight": torch.zeros(1), **sd}},
                   bad)
        load_pth(t.model, bad)
    # a directory with no checkpoint raises as the JAX Inferencer does; an
    # orbax step directory of the JAX package (its params fp32, as the
    # .pth above) serves the same outputs
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        api.Inferencer(AttrDict.from_nested(cfg_dict()),
                       ckpt_path=str(tmp_path), device="cpu")
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), jinf.params)
    jsave(str(tmp_path / "ckp"), 3, jstep.TrainState(
        params, optax.sgd(0.1).init(params), np.asarray(3, np.int32)))
    t = api.Inferencer(AttrDict.from_nested(cfg_dict()),
                       ckpt_path=str(tmp_path / "ckp"),
                       compute_dtype=torch.float64, device="cpu")
    got = t.evaluate_image(vol, keep_feat=False)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=F64_ATOL,
                                   err_msg=k)


def test_bf16_inferencer_runs_on_cpu():
    """bf16 autocast around the model: outputs lifted to fp32, labels from
    the same table."""
    t = api.Inferencer(AttrDict.from_nested(cfg_dict()),
                       compute_dtype=torch.bfloat16, exact=False,
                       device="cpu")
    out = t.evaluate_image(np.random.default_rng(15).random((16, 16, 16)),
                           keep_feat=False)
    assert out["T1"].dtype == torch.float32
    assert out["label"].dtype == torch.int32
    lab = set(t.cfg.label_list_segmentation)
    assert set(out["label"].unique().tolist()) <= lab


# --------------------------------------------------------------- CLI twins


def test_cli_twins_on_cpu(tmp_path):
    from brainfm_tpu_torch.scripts import demo_get_feature, demo_test

    img = head_file(str(tmp_path / "img.nii.gz"), (30, 36, 24),
                    (1.2, 1.0, 1.5), seed=16)
    atlas = str(tmp_path / "atlas.mgz")
    chip_smoke.write_mgz(atlas, chip_smoke.procedural_atlas(
        (48, 48, 48), seed=2, dev="cpu"), (5.0, 5.0, 5.0))
    small = tmp_path / "small.yaml"
    small.write_text("f_maps: 8\nnum_levels: 3\ntask_f_maps: [8]\n")
    common = ["--device", "cpu", "--train_cfg", str(small)]
    for extra, tag in (([], "whole"), (["--tiled", "--tile_win", "16", "16",
                                        "16", "--stride", "8", "8", "8"],
                                       "tiled")):
        out = tmp_path / tag
        assert demo_test.main([img, "--save_dir", str(out), "--win", "24",
                               "24", "24", "--exact", "--atlas", atlas,
                               *common, *extra]) == 0
        files = set(os.listdir(out))
        assert {"out_label.nii.gz", "out_T1.nii.gz",
                "out_deformed_atlas.nii.gz"} <= files
        v, _ = nifti.load_nifti(str(out / "out_deformed_atlas.nii.gz"))
        assert v.shape == (24, 24, 24) and np.isfinite(v).all()
    npy = str(tmp_path / "feat.npy")
    assert demo_get_feature.main([img, "--win", "24", "24", "24",
                                  "--save_path", npy, *common]) == 0
    assert np.load(npy).shape == (1, 24, 24, 24, 8)
