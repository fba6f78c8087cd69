"""The space-sharded UNet of the port on the CPU at fp64: the joint model
(L6, f_maps 8) over a 48^3 volume split in two D slabs (levels 48, 24, 12
sharded; 6, 3, 1 whole on every rank), one train step's loss and
gradients on two spawned gloo ranks against the unsharded port and
against the JAX package's unsharded value_and_grad with the same weights
(from_jax_params); the pooled age head with unit_feat on; and a
data=2 x space=2 run on four ranks. The gradients are summed over the
ranks, as the train step sums them."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brainfm_tpu.models.build import apply_processors as japply
from brainfm_tpu.models.criterion import make_criterion as jcriterion
from brainfm_tpu.models.criterion import weighted_total as jweighted
from brainfm_tpu_torch.models import from_jax_params

import _torch_dist as td
from _torch_train_util import jax_model, rel_l2, to_jax

LOSS_RTOL = 1e-12
GRAD_RTOL = 1e-9     # rel-L2 of the whole gradient (every tensor)
JAX_RTOL = 1e-9
# each tensor on its own: the first GroupNorm's weight (one channel) has a
# gradient that sums +-terms over 2 x 48^3 voxels to a value ~1e4 times
# smaller than their magnitude, so fp64 summation order alone moves it by
# some 1e-9 of itself; a wrong exchange moves a tensor by O(1)
TENSOR_RTOL = 1e-7
SIZE = (48, 48, 48)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn both rank groups, then compute the JAX reference while they
    run: (space=2 ranks, data=2 x space=2 ranks, JAX (loss, grads))."""
    jax.config.update("jax_enable_x64", True)
    try:
        jcfg, jm, params = jax_model(f_maps=8, num_levels=6, size=SIZE)
        tmp = tmp_path_factory.mktemp("spatial")
        torch.save(from_jax_params(params), tmp / "jax_weights.pt")
        h2 = td.spawn("spatial", 2, tmp)
        h4 = td.spawn("spatial_dxs", 4, tmp_path_factory.mktemp("dxs"))
        _, jw, jfn = jcriterion(jcfg)
        batch = td.np_batch(3, jcfg.n_labels, SIZE, B=1, S=2)

        def loss(p, b):
            def per_item(s, t):
                return jfn(japply(jm.apply(p, s["input"]), jcfg), t, s)

            ls = jax.vmap(per_item)(b["samples"], b["targets"])
            return jweighted({k: jnp.mean(v) for k, v in ls.items()}, jw)

        jl, jg = jax.jit(jax.value_and_grad(loss))(params, to_jax(batch))
        jref = (float(jl), {k: v.numpy() for k, v in from_jax_params(
            jax.tree.map(np.asarray, jg)).items()})
    finally:
        jax.config.update("jax_enable_x64", False)
    return td.collect(h2), td.collect(h4), jref


def _check(got, ref, loss_rtol, grad_rtol):
    loss, grads = ref
    np.testing.assert_allclose(got["loss"], loss, rtol=loss_rtol)
    assert set(got["grads"]) == set(grads)
    keys = sorted(grads)
    whole = rel_l2(np.concatenate([np.ravel(got["grads"][k]) for k in keys]),
                   np.concatenate([np.ravel(grads[k]) for k in keys]))
    assert whole <= grad_rtol, whole
    bad = {k: rel_l2(got["grads"][k], grads[k]) for k in keys}
    bad = {k: v for k, v in bad.items() if not v <= TENSOR_RTOL}
    assert not bad, bad


@pytest.mark.parametrize("kind", ["joint", "age"])
def test_space2_matches_the_unsharded_port(runs, kind):
    """Loss 1e-12, the gradient rel-L2 1e-9 (each tensor 1e-7); 'age' is
    joint_age.yaml with unit_feat on: the pooled head gathers its feature
    and runs whole, the unit-normalized feature stays on the slabs."""
    ranks, _, _ = runs
    for r in ranks:
        _check(r[kind], ranks[0][kind]["ref"], LOSS_RTOL, GRAD_RTOL)
    if kind == "age":
        assert "head.final_linear1_age.weight" in ranks[0]["age"]["grads"]


def test_space2_matches_jax(runs):
    """The sharded step against the JAX package's unsharded value_and_grad
    of the same loss with the same weights: 1e-9."""
    ranks, _, jref = runs
    _check(ranks[0]["joint"], jref, JAX_RTOL, JAX_RTOL)
    loss, grads = ranks[0]["joint"]["ref"]
    _check({"loss": loss, "grads": grads}, jref, JAX_RTOL, JAX_RTOL)


def test_data2_space2_matches_the_unsharded_port(runs):
    """Four ranks, two items (one per data rank, S=1), each item's volume
    in two slabs: the mean loss over the data ranks and the world's sum
    of the gradients against one process on both items."""
    _, ranks, _ = runs
    for r in ranks:
        _check(r["joint_b2"], ranks[0]["joint_b2"]["ref"], LOSS_RTOL,
               GRAD_RTOL)
