"""The frozen implicit-pathology critic (the flagship with
losses.implicit_pathol and a random-init critic) against the JAX package
on the CPU at fp64, weights handed across by from_jax_params: its outputs
and gradients, one AdamW train step of the critic-on flagship (monolithic
and with sample_accum 2) against the JAX package's jitted make_train_step,
and the critic's checkpoint handling and seeding. The model and the critic
are cut to f_maps 8 and 3 levels; the JAX reference (model and critic) at
32^3 is built once for the module."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brainfm_tpu.models import build as jbuildmod
from brainfm_tpu_torch.config import AttrDict
from brainfm_tpu_torch.config import load_config as tload
from brainfm_tpu_torch.models import (build_critic_from_cfg,
                                      implicit_pathol_outputs)

from _torch_variants_util import (ATOL, SIZE, check_step,  # noqa: F401
                                  port_critic, variant_cfg, variant_ref, x64)

NAME = "critic"


@pytest.fixture(scope="module")
def ref():
    return variant_ref(NAME)


def test_critic_outputs_match_jax(ref):
    """implicit_pathol_outputs: the critic's sigmoid on the predicted and
    the target image at fp64; gradients reach the predicted image and
    never the critic; the target's score carries none."""
    jcfg = ref["jcfg"]
    jcritic, jparams, jkey = ref["critic"]
    cfg = variant_cfg(tload, "critic")
    cfg.tasks = list(jcfg.tasks)
    critic, key = port_critic(cfg, jparams)
    assert key == jkey == "T1"
    assert not critic.training
    assert not any(p.requires_grad for p in critic.parameters())
    rng = np.random.default_rng(9)
    pred = rng.random((3, *SIZE, 1))
    tgt = rng.random((1, *SIZE, 1))
    want = jax.jit(lambda cp, o, t: jbuildmod.implicit_pathol_outputs(
        jcritic, cp, {"T1": o}, {"T1": t}, "T1"))(
        jparams, jnp.asarray(pred), jnp.asarray(tgt))
    t_pred = torch.from_numpy(pred).requires_grad_(True)
    got = implicit_pathol_outputs(critic, {"T1": t_pred},
                                  {"T1": torch.from_numpy(tgt)}, "T1")
    for k in ("implicit_pathol_pred", "implicit_pathol_orig"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), atol=ATOL, err_msg=k)
    assert not got["implicit_pathol_orig"].requires_grad
    got["implicit_pathol_pred"].sum().backward()
    assert t_pred.grad is not None and float(t_pred.grad.abs().sum()) > 0
    assert all(p.grad is None for p in critic.parameters())


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name", [NAME])
def test_variant_step_matches_jax(ref, name, accum):
    """One fp64 AdamW step of the critic-on flagship (critic frozen, its
    losses through the predicted image), monolithic and in 2 sample
    microbatches: metrics rtol 1e-10, params rel-L2 < 1e-9 per tensor;
    the critic's weights stay as they were."""
    check_step(ref, name, accum)


# ----------------------------------------------------- critic checkpoints

def test_critic_loads_checkpoints_and_refuses_a_partial_one(tmp_path):
    """supervised_pathol_seg_ckp_path: one .pth of the whole critic, or
    {feat: bare backbone, task: head} that together name every weight,
    load exactly; a path not on disk raises FileNotFoundError (as the
    JAX package does); parts that leave weights unloaded raise."""
    cfg = variant_cfg(tload, "critic", (16, 16, 16))
    cfg.tasks = ["T1"]
    with pytest.warns(UserWarning):
        ref, _ = build_critic_from_cfg(cfg, device="cpu", seed=11)
    sd = ref.state_dict()
    torch.save({"model": sd}, tmp_path / "critic.pth")
    torch.save({k.removeprefix("backbone."): v for k, v in sd.items()
                if k.startswith("backbone.")}, tmp_path / "feat.pth")
    torch.save({k: v for k, v in sd.items() if k.startswith("head.")},
               tmp_path / "task.pth")
    for ckp in (str(tmp_path / "critic.pth"),
                {"feat": str(tmp_path / "feat.pth"),
                 "task": str(tmp_path / "task.pth")}):
        cfg.supervised_pathol_seg_ckp_path = ckp
        critic, _ = build_critic_from_cfg(cfg, device="cpu")
        for k, t in critic.state_dict().items():
            assert torch.equal(t, sd[k]), k
    cfg.supervised_pathol_seg_ckp_path = {
        "feat": str(tmp_path / "feat.pth"),
        "task": str(tmp_path / "typo.pth")}
    with pytest.raises(FileNotFoundError, match="typo.pth"):
        build_critic_from_cfg(cfg, device="cpu")
    cfg.supervised_pathol_seg_ckp_path = {"feat": str(tmp_path / "feat.pth")}
    with pytest.raises(ValueError, match="unloaded"):
        build_critic_from_cfg(cfg, device="cpu")


def test_critic_needs_an_image_task_and_is_seeded():
    """No image task to score raises ValueError; the random init depends
    on the seed only (not on the caller's RNG state)."""
    cfg = AttrDict.from_nested({"losses": {"implicit_pathol": True},
                                "critic_f_maps": 8, "critic_num_levels": 2})
    cfg.tasks = ["segmentation"]
    with pytest.raises(ValueError, match="image task"):
        build_critic_from_cfg(cfg, device="cpu")
    cfg.tasks = ["segmentation", "FLAIR"]
    with pytest.warns(UserWarning):
        torch.manual_seed(1)
        a, key = build_critic_from_cfg(cfg, device="cpu")
        torch.manual_seed(2)
        b, _ = build_critic_from_cfg(cfg, device="cpu")
    assert key == "FLAIR"
    assert all(torch.equal(t, b.state_dict()[k])
               for k, t in a.state_dict().items())
