"""FSDP training of the port (parallel/fsdp.py, train/step.py) on two
spawned gloo CPU ranks at fp64: two AdamW steps (per-tensor clip on) under
data=2 FSDP and data=2 replicated against one process's steps on the
whole batch; a NaN in one rank's items skips the step on both; init_sharded
against the replicated init from the same seed; and the FSDP checkpoint
(gathered, written by rank 0) loaded back into the shards and into a
single-device model, optimizer and Inferencer, bitwise."""

import os

import numpy as np
import pytest
import torch

from brainfm_tpu_torch.infer import Inferencer
from brainfm_tpu_torch.models.criterion import make_criterion
from brainfm_tpu_torch.train import checkpoint as ckpt
from brainfm_tpu_torch.train import loop
from brainfm_tpu_torch.train.step import TrainState, build_optimizer

import _torch_dist as td

PARAM_RTOL = 1e-12


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    return td.run("fsdp", 2, tmp), tmp


def _rel(a, b):
    return float((a - b).norm() / max(float(b.norm()), 1e-300))


@pytest.mark.parametrize("mode", ["fsdp", "replicated"])
def test_two_adamw_steps_match_one_process(ranks, mode):
    """Per-step losses 1e-12 and every parameter after the steps within
    rel 1e-12 of the single process's; the NaN step skipped on both
    ranks, the step count left at 2."""
    rs, _ = ranks
    single = rs[0]["single"]
    assert single["skipped"] == 1.0 and single["step"] == 2
    for r in rs:
        got = r[mode]
        np.testing.assert_allclose(got["losses"], single["losses"],
                                   rtol=PARAM_RTOL)
        assert got["skipped"] == 1.0 and got["step"] == 2
        for k, v in single["params"].items():
            assert _rel(got["params"][k], v) <= PARAM_RTOL, k


def test_sample_accumulation_on_a_data_mesh(ranks):
    """sample_accum=2 (the S=2 stack in two microbatches) on data=2
    against one process on the whole batch."""
    rs, _ = ranks
    want = rs[0]["accum_single"]
    for r in rs:
        np.testing.assert_allclose(r["accum"]["loss"], want["loss"],
                                   rtol=PARAM_RTOL)
        for k, v in want["params"].items():
            assert _rel(r["accum"]["params"][k], v) <= PARAM_RTOL, k


def test_fsdp_steps_an_fp32_model_over_gloo(ranks):
    rs, _ = ranks
    for r in rs:
        assert np.isfinite(r["fp32_loss"]) and r["fp32_step"] == 1


def test_init_sharded_matches_the_replicated_init(ranks):
    """Bitwise the replicated build's values from the same torch seed,
    with each rank holding about half of them."""
    rs, _ = ranks
    for r in rs:
        assert r["init_plain"].keys() == r["init_sharded"].keys()
        for k, v in r["init_plain"].items():
            assert torch.equal(r["init_sharded"][k], v), k
        assert r["init_local_numel"] <= r["init_numel"] // 2 + 200


def test_fsdp_requires_a_mesh(tmp_path):
    cfg, model = td._small_model()
    _, w, fn = make_criterion(cfg)
    with pytest.raises(ValueError, match="fsdp=True requires a mesh"):
        loop.train(cfg, model, w, fn, None, str(tmp_path), fsdp=True)


def test_fsdp_checkpoint_resumes_into_the_shards(ranks):
    rs, _ = ranks
    for r in rs:
        assert r["resumed_step"] == 2
        for k, v in r["fsdp"]["params"].items():
            assert torch.equal(r["resumed"][k], v), k
        for i, st in r["opt_full"].items():
            for kk, v in st.items():
                assert torch.equal(r["resumed_opt"][i][kk], v), (i, kk)


def test_fsdp_checkpoint_loads_on_one_device(ranks):
    """train()'s load_checkpoint and Inferencer on one process read the
    checkpoint rank 0 wrote: weights and AdamW moments bitwise."""
    rs, tmp = ranks
    path = os.path.join(tmp, "ckp", "ckpt_000002")
    assert ckpt.read_extra(path) == {"epoch": 0}
    cfg, model = td._small_model(seed=5)
    st = ckpt.load_checkpoint(path, TrainState(
        model, build_optimizer(cfg, model.parameters())))
    assert st.step == 2
    want = rs[0]["fsdp"]["params"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    for i, s in st.optimizer.state_dict()["state"].items():
        for kk, v in s.items():
            assert torch.equal(v, rs[0]["opt_full"][i][kk]), (i, kk)
    inf = Inferencer(cfg, ckpt_path=path, compute_dtype=torch.float64,
                     device="cpu")
    for k, v in inf.model.state_dict().items():
        assert torch.equal(v, want[k]), k
