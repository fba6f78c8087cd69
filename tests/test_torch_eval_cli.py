"""The port's batch-evaluation CLI (brainfm_tpu_torch/scripts/test.py)
with --device cpu against the JAX package's scripts/test.py
(run_inference_cases, run_pair_eval) on the CPU: two 32^3 procedural
heads with label-map and MNI-x companions, two small models (f_maps 8, 3
levels) from .pth files that both packages read, --spacings native 2,2,3
with --add_bf, hemisphere masking and the deformed atlas; then file-pair
scoring (is_seg dice, recon psnr, ssim, l1) of the same prediction files
by both CLIs."""

import argparse
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from brainfm_tpu.config import load_config as jload
from brainfm_tpu_torch.config import load_config as tload
from brainfm_tpu_torch.models import build_model
from brainfm_tpu_torch.scripts import test as test_cli
from brainfm_tpu_torch.utils import nifti

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

WIN = 32
# tests/test_torch_serve.py's tolerances: fp32 models on both sides,
# relative to the largest |output| (at least 1), and the share of labels
# that must agree (a near-tied fp32 argmax may flip)
F32_MODEL_RTOL = 1e-4
LABEL_AGREE_F32 = 0.999
# the deformed atlas samples the atlas at 100x the predicted coordinates,
# inside the predicted brain: where the label flips, a voxel changes
# wholesale
ATLAS_AGREE = 0.999
# scores of the same files, fp32 on both sides
SCORE_RTOL = 1e-5


def _jax_cli():
    sys.path.insert(0, ROOT)
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_test_cli", os.path.join(ROOT, "scripts", "test.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(ROOT)
    return mod


def _inputs(tmp):
    """Two heads with label maps (left labels and others) and MNI-x maps,
    a small atlas, two .pth models and the small-model YAML."""
    data = os.path.join(tmp, "data")
    os.makedirs(data)
    # 1 mm voxels (a permuted, flipped affine): the label map is not
    # resampled, since an interpolated label truncates on a knife edge
    # that fp32 rounding decides (tests/test_torch_serve.py holds the
    # resample itself)
    shape, vox = (30, 36, 28), (1.0, 1.0, 1.0)
    aff = chip_smoke.serve_affine(shape, vox)
    for i in range(2):
        head = chip_smoke.procedural_head(shape, vox, 30 + i, "cpu")
        nifti.save_nifti(os.path.join(data, f"sub{i}.nii.gz"), head, aff)
        rng = np.random.default_rng(i)
        seg = np.where(head > 0, rng.choice([2, 3, 41, 42, 17], shape), 0)
        nifti.save_nifti(os.path.join(data, f"sub{i}.seg.nii.gz"),
                         seg.astype(np.int32), aff)
        # MNI x: a step from -1 to 0.7 across the volume, so no resampled
        # value lies within fp32 rounding of the mask's threshold 0
        x = np.where(np.arange(shape[2]) < shape[2] // 2, -1.0, 0.7)
        x = x[None, None] * np.ones(shape)
        nifti.save_nifti(os.path.join(data, f"sub{i}.mni_reg.x.nii.gz"),
                         x.astype(np.float32), aff)
    atlas = os.path.join(tmp, "atlas.mgz")
    chip_smoke.write_mgz(atlas, chip_smoke.procedural_atlas(
        (48, 48, 48), seed=2, dev="cpu"), (5.0, 5.0, 5.0))
    small = os.path.join(tmp, "small.yaml")
    with open(small, "w") as f:
        # unit_feat off, as tests/test_torch_serve.py's models: the unit
        # normalization of the last feature divides by norms that are small
        # at some voxels and magnifies fp32 rounding there
        f.write("f_maps: 8\nnum_levels: 3\ntask_f_maps: [8]\n"
                "unit_feat: false\n")
    files = [os.path.join(ROOT, "cfgs/generator/default.yaml"),
             os.path.join(ROOT, "cfgs/trainer/default_train.yaml"),
             os.path.join(ROOT, "cfgs/trainer/default_val.yaml"), small]
    cfg = jload(files)
    models = []
    for i, name in enumerate(("a", "b")):
        torch.manual_seed(i)
        _, model = build_model(tload(files), device="cpu")
        p = os.path.join(tmp, f"{name}.pth")
        torch.save({"model": model.state_dict()}, p)
        models.append(f"{name}={p}")
    return data, atlas, small, cfg, models


def _tree(root):
    out = []
    for d, _, fs in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root) for f in fs]
    return sorted(out)


def _args(**kw):
    ap = test_cli.build_parser()
    return ap.parse_args([]).__class__(**{**vars(ap.parse_args([])), **kw})


def test_eval_cli_matches_jax(tmp_path):
    tmp = str(tmp_path)
    data, atlas, small, jcfg, models = _inputs(tmp)
    common = ["--input_glob", os.path.join(data, "sub?.nii.gz"),
              "--models", *models, "--spacings", "native", "2,2,3",
              "--add_bf", "--hemis_seg_suffix", ".seg.nii.gz",
              "--atlas", atlas, "--win", str(WIN), str(WIN), str(WIN),
              "--train_cfg", small]
    assert test_cli.main([*common, "--save_dir", os.path.join(tmp, "port"),
                          "--device", "cpu"]) == 0

    jcli = _jax_cli()
    jargs = _args(input_glob=os.path.join(data, "sub?.nii.gz"),
                  models=models, spacings=["native", "2,2,3"], add_bf=True,
                  hemis_seg_suffix=".seg.nii.gz", atlas=atlas,
                  win=[WIN] * 3, save_dir=os.path.join(tmp, "jax"),
                  train_cfg=small)
    jcli.run_inference_cases(jargs, jcfg, jcli.parse_setups(
        jargs.spacings, [False, True]))

    tree = _tree(os.path.join(tmp, "port"))
    assert tree == _tree(os.path.join(tmp, "jax"))
    tags = sorted({p.split(os.sep)[0] for p in tree})
    assert tags == ["a_1-1-1", "a_2.0-2.0-3.0", "a_BF_1-1-1",
                    "a_BF_2.0-2.0-3.0", "b_1-1-1", "b_2.0-2.0-3.0",
                    "b_BF_1-1-1", "b_BF_2.0-2.0-3.0"]
    assert "a_1-1-1/sub0/out_deformed_atlas.nii.gz" in tree
    assert "a_1-1-1/sub0/hemis_mask.nii.gz" in tree
    assert not any(p.endswith(("out_feat.nii.gz",)) for p in tree)
    for rel in tree:
        got = nifti.load_nifti(os.path.join(tmp, "port", rel))[0]
        want = nifti.load_nifti(os.path.join(tmp, "jax", rel))[0]
        assert got.shape == want.shape, rel
        name = os.path.basename(rel)
        if name in ("out_label.nii.gz", "hemis_mask.nii.gz"):
            assert np.mean(got == want) >= LABEL_AGREE_F32, rel
        elif name == "out_deformed_atlas.nii.gz":
            assert np.mean(np.abs(got - want) <= 1e-3) >= ATLAS_AGREE, rel
        else:
            scale = max(float(np.abs(want).max()), 1.0)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=F32_MODEL_RTOL * scale,
                                       err_msg=rel)
    hemis = nifti.load_nifti(os.path.join(
        tmp, "port", "a_1-1-1", "sub0", "hemis_mask.nii.gz"))[0]
    assert 0 < hemis.mean() < 1

    # scoring: the port's predictions of one setup against ground truth
    # written beside them, by both CLIs
    setup = os.path.join(tmp, "port", "a_1-1-1")
    for i in range(2):
        d = os.path.join(setup, f"sub{i}")
        t1 = nifti.load_nifti(os.path.join(d, "out_T1.nii.gz"))[0]
        nifti.save_nifti(os.path.join(d, "out_T1.gt.nii.gz"),
                         np.clip(t1 + 0.05 * np.sin(np.arange(t1.size))
                                 .reshape(t1.shape), 0, None)
                         .astype(np.float32))
        lab = nifti.load_nifti(os.path.join(d, "out_label.nii.gz"))[0]
        lab = lab.astype(np.int32)
        lab[::3] = 0
        nifti.save_nifti(os.path.join(d, "out_label.gt.nii.gz"), lab)
    for kind, pattern, extra in (
            ("recon", "out_T1.nii.gz", {"metrics": [
                "recon_psnr", "recon_ssim", "recon_l1"]}),
            ("seg", "out_label.nii.gz", {"metrics": ["seg_dice"],
                                         "is_seg": True})):
        glob_ = os.path.join(setup, "*", pattern)
        out_t = os.path.join(tmp, f"scores_port_{kind}")
        out_j = os.path.join(tmp, f"scores_jax_{kind}")
        argv = ["--pred_glob", glob_, "--metrics", *extra["metrics"],
                "--save_dir", out_t, "--device", "cpu"]
        if extra.get("is_seg"):
            argv.append("--is_seg")
        assert test_cli.main(argv) == 0
        jcli.run_pair_eval(_args(pred_glob=glob_, save_dir=out_j, **extra),
                           jcfg)
        got = json.load(open(os.path.join(out_t, "scores.json")))
        want = json.load(open(os.path.join(out_j, "scores.json")))
        # per_case is keyed by file name, as in the JAX package (both
        # subjects' files share one); the means are over both pairs
        assert got["per_case"].keys() == want["per_case"].keys()
        for k, v in want["mean"].items():
            assert abs(got["mean"][k] - v) <= SCORE_RTOL * max(abs(v), 1.0), \
                (kind, k, got["mean"][k], v)


def test_eval_cli_setup_grid_and_refusals():
    jcli = _jax_cli()
    for spacings in (["native"], ["native", "1.5,1.5,5", "1,1,1"]):
        for bf in ([False], [False, True]):
            assert test_cli.parse_setups(spacings, bf) == \
                jcli.parse_setups(spacings, bf)
    assert test_cli.setup_tag("joint", [1.5, 1.5, 5.0], True) == \
        "joint_BF_1.5-1.5-5.0"
    with pytest.raises(SystemExit):
        test_cli._models(_args(models=["no_equals_sign"]))
