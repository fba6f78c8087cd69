"""The served two-stage pair (models/build.py TwoStage through
infer/api.py TwoStageInferencer) against the benchmark's plain reference
(brainbench/reference/twostage.py) on the CPU: the benchmark's `twostage`
configuration cut to f_maps 8, 3 levels, with the same seeded weights on
both sides (brainbench/inputs.py::seed_weights). The forward's mask, every
stage-1 output and the label map at float64 and float32; evaluate_path's
written files against the reference's prepare_image, forward and
postprocess; the mask squashed once. This file imports nothing of JAX."""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import pytest
import torch

from brainbench import inputs
from brainbench.reference import model as rm
from brainbench.reference import twostage as rt
from brainbench.reference.prepare import prepare_image as ref_prepare
from brainbench.reference.utils.nifti import load_nifti
from brainfm_tpu_torch.config import AttrDict
from brainfm_tpu_torch.infer import TwoStageInferencer
from brainfm_tpu_torch.models.build import (build_inpaint_model,
                                            process_outputs)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2000000017
SIZE = (24, 24, 24)
HEAD, WIN = (40, 48, 32), (40, 40, 40)


def small_tree():
    with open(os.path.join(ROOT, "brainbench", "configs",
                           "twostage.json")) as f:
        tree = json.load(f)["cfg"]
    tree["f_maps"], tree["num_levels"], tree["task_f_maps"] = 8, 3, [8]
    return tree


@pytest.fixture(scope="module")
def pair():
    """(port cfg, port TwoStage, ref cfg, ref pair), the same weights."""
    tree = small_tree()
    cfg, model = build_inpaint_model(AttrDict.from_nested(copy.deepcopy(
        tree)), device="cpu")
    rcfg, ref = rt.build_model(rm.Cfg.from_nested(copy.deepcopy(tree)),
                               "cpu")
    w = inputs.seed_weights(inputs.weight_specs(model), SEED, "cpu")
    inputs.load_weights(model, w)
    inputs.load_weights(ref, w)
    return cfg, model.eval(), rcfg, ref.eval()


def _rel(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def _volume(dtype):
    g = torch.Generator().manual_seed(3)
    return torch.rand((1,) + SIZE + (1,), generator=g, dtype=dtype)


def _both(pair, dtype):
    cfg, model, rcfg, ref = pair
    x = _volume(dtype)
    with torch.no_grad():
        out = process_outputs(model, copy.deepcopy(model).to(dtype)(x), cfg)
        want = rt.apply_processors(copy.deepcopy(ref).to(dtype)(x), rcfg)
    return out, want, rm.postprocess(want, rcfg)


# Relative L2 per output. float64: both sides compute the same sums in
# another order, so rounding of about 1e-16 an operation separates them
# (read 2e-15 to 6e-14). float32: the port's GroupNorm forms its
# statistics from one-pass sums (ops/groupnorm.py) where F.group_norm
# centres first, and the difference grows through the two chained UNets
# and the unit-length features (read 1e-6 for the mask to 4e-5 for T1)
FP32_TOL = 3e-4


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, FP32_TOL)])
def test_pair_matches_the_reference(pair, dtype, tol):
    out, want, post = _both(pair, dtype)
    keys = set(want)
    assert keys == {"pathology", "T1", "T2", "FLAIR", "CT", "segmentation"}
    assert keys <= set(out)
    for k in sorted(keys):
        assert out[k].shape == want[k].shape, k
        assert _rel(out[k], want[k]) < tol, (k, _rel(out[k], want[k]))
    # the label map: the argmax of the same softmax; with random weights
    # two classes can tie to within the float32 rounding above, so a
    # voxel in ten thousand may take the other label at float32
    lab = rm.postprocess(process_outputs(pair[1], {
        "segmentation": out["segmentation"]}, pair[0]), pair[2])["label"]
    miss = float((lab != post["label"]).double().mean())
    assert miss <= (0.0 if dtype == torch.float64 else 1e-4), miss


def test_the_mask_is_squashed_once(pair):
    cfg, model, _, _ = pair
    x = _volume(torch.float64)
    m64 = copy.deepcopy(model).double()
    with torch.no_grad():
        m = torch.sigmoid(m64.pathol(x)["pathology"])
        out = process_outputs(m64, m64(x), cfg)
    assert torch.equal(out["pathology"], m)
    # a second sigmoid would put every voxel in (0.5, 0.74)
    assert float(m.min()) < 0.45 or float(m.max()) > 0.8
    assert not torch.allclose(out["pathology"], torch.sigmoid(m))


@pytest.fixture(scope="module")
def head(tmp_path_factory):
    d = tmp_path_factory.mktemp("head")
    mm, axes = [1.2, 1.0, 1.5], [[0, 0, -1], [1, 0, 0], [0, -1, 0]]
    path = str(d / "head00.nii.gz")
    inputs.write_nifti_gz(path, inputs.procedural_head(HEAD, mm, SEED, 0,
                                                       "cpu"),
                          inputs.serve_affine(HEAD, mm, axes))
    return path


def test_evaluate_path_matches_the_reference(pair, head, tmp_path):
    """The written label map, mask and images of
    TwoStageInferencer.evaluate_path
    (float32, TF32 off: the exact path) against the reference's
    prepare_image, float32 forward and postprocess of the same file."""
    _, model, rcfg, ref = pair
    inf = TwoStageInferencer(AttrDict.from_nested(small_tree()),
                             compute_dtype=torch.float32, exact=True,
                             device="cpu")
    inf.model.load_state_dict(model.state_dict())
    (out_dir,) = inf.evaluate_path([head], str(tmp_path), win_size=WIN,
                                   ext=".nii.gz")
    im = ref_prepare(head, list(WIN), device="cpu")[0]
    with torch.no_grad():
        want = rm.postprocess(rt.apply_processors(
            ref(im[None, ..., None].float()), rcfg), rcfg)
    lab = load_nifti(os.path.join(out_dir, "out_label.nii.gz"))[0]
    ref_lab = want["label"][0, ..., 0].numpy()
    assert lab.shape == ref_lab.shape
    # the float32 argmax ties of test_pair_matches_the_reference
    assert np.mean(lab != ref_lab) <= 1e-4
    # the mask and the images as written (float32, clipped at 0; the mask,
    # a sigmoid, is positive), within the float32 tolerance above
    for k in ("pathology", "T1", "T2", "FLAIR", "CT"):
        got = load_nifti(os.path.join(out_dir, f"out_{k}.nii.gz"))[0]
        assert _rel(torch.from_numpy(np.asarray(got, np.float64)),
                    want[k][0, ..., 0].clamp(min=0)) < FP32_TOL, k
