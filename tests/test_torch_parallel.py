"""The port's multi-GPU layer (brainfm_tpu_torch/parallel) on the CPU:
fsdp_spec against the JAX package's rule, make_mesh's checks, and on two
spawned gloo ranks (space=2) the halo exchange forward and backward,
gather_space / slice_space (NDHWC slabs kept NDHWC), a blur tower through
spatial_shard_conv_apply against the JAX package's on a 2-device JAX mesh
at fp64, and the space-sharded GroupNorm (`fused_group_norm` with the
space group) against the JAX package's `_fused_groupnorm` of the whole
tensor at fp64 and against the unsharded port in bf16."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brainfm_tpu.parallel import fsdp as jfsdp
from brainfm_tpu.parallel import mesh as jmesh
from brainfm_tpu.parallel import spatial as jspatial
from brainfm_tpu_torch import parallel
from brainfm_tpu_torch.models import build_model
from brainfm_tpu_torch.parallel import fsdp, mesh

import _torch_dist as td

TOL = 1e-12
# the slab GroupNorm against `_fused_groupnorm` at fp64, as
# tests/test_torch_groupnorm.py (the sums are added in other orders)
GN_VAL_TOL = 1e-10
GN_GRAD_TOL = 1e-8


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return td.run("parallel", 2, tmp_path_factory.mktemp("parallel"))


def _flagship_shapes():
    cfg = td.joint_cfg(64, 6, (160, 160, 160))
    _, model = build_model(cfg, device="meta")
    return [tuple(p.shape) for p in model.parameters()]


def test_the_jax_names_resolve():
    from brainfm_tpu import parallel as jparallel
    from brainfm_tpu_torch.synth.sharded import sharded_synth_batch

    assert set(jparallel.__all__) <= set(parallel.__all__)
    for name in parallel.__all__:
        assert callable(getattr(parallel, name)), name
    assert callable(sharded_synth_batch)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_fsdp_spec_is_the_jax_rule(n):
    """Every parameter shape of the f_maps-64 L6 flagship and a few odd
    ones: the dimension the JAX PartitionSpec names, or None for P()."""
    shapes = _flagship_shapes() + [(), (1,), (7,), (6, 9), (3, 5, 7),
                                   (64, 64, 3, 3, 3), (56, 64, 1, 1, 1),
                                   (4, 4), (2, 6, 6)]
    for s in shapes:
        want = jfsdp.fsdp_spec(s, n)
        d = fsdp.fsdp_spec(s, n)
        assert (d is None) == (len(want) == 0 or all(a is None for a in want))
        if d is not None:
            assert want[d] == "data" and sum(a is not None for a in want) == 1


def test_make_mesh_checks_the_world():
    """Without a process group the world is one process: any other mesh
    size is the JAX assertion's message; a fitting one needs
    init_distributed first."""
    with pytest.raises(ValueError, match=r"mesh 2x1 != 1 devices"):
        mesh.make_mesh(2)
    with pytest.raises(ValueError, match=r"mesh 1x2 != 1 devices"):
        mesh.make_mesh(1, 2)
    with pytest.raises(RuntimeError, match="init_distributed"):
        mesh.make_mesh(1, 1)
    assert mesh.init_distributed() == (0, 1)
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)


def test_make_mesh_error_in_a_two_process_world(ranks):
    for r in ranks:
        assert r["mesh_error"] == "mesh 3x1 != 2 devices"


@pytest.mark.parametrize("what", ["halo_fwd", "halo_bwd", "gather_fwd",
                                  "gather_bwd", "slice_bwd", "shard_batch",
                                  "replicate"])
def test_exchanges_forward_and_backward(ranks, what):
    """The halo exchange against the zero-padded whole volume's windows
    (each halo's gradient added to its owner's edge); gather_space's
    backward sums the ranks' gradients; slice_space's zero-pads;
    shard_batch takes this rank's rows (data=2) or D slab (space=2);
    replicate gives every rank rank 0's tensors and weights."""
    for r in ranks:
        assert r[what] <= TOL, (what, r[what])


@pytest.mark.parametrize("what", ["halo", "gather", "slice"])
def test_exchanges_keep_a_channels_last_slab(ranks, what):
    """halo_exchange, gather_space and slice_space on an NDHWC slab (the
    card's layout, a space scope's included): the output and the gradient
    stay NDHWC, with the NCDHW slab's values and gradients."""
    for r in ranks:
        err, kept = r[f"cl_{what}"]
        assert kept and err <= TOL, (what, err, kept)


def test_blur_tower_matches_jax_spatial_shard_conv_apply(ranks):
    """Two 3^3 convs through spatial_shard_conv_apply with halo 2 over two
    slabs, against the JAX function on a 2-device mesh (same halo
    semantics, so equal everywhere, the volume's ends included)."""
    vol = ranks[0]["blur_input"].numpy()
    w1, w2 = (w.numpy() for w in ranks[0]["blur_w"])
    got = torch.cat([r["blur_slab"] for r in ranks], dim=2).numpy()
    jax.config.update("jax_enable_x64", True)
    try:
        def conv(x, w):
            return jax.lax.conv_general_dilated(
                x, jnp.asarray(w.transpose(2, 3, 4, 1, 0)), (1, 1, 1),
                "SAME", dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
                precision=jax.lax.Precision.HIGHEST)

        jm = jmesh.make_mesh(data=1, space=2, devices=jax.devices()[:2])
        want = jspatial.spatial_shard_conv_apply(
            lambda p, x: conv(conv(x, p[0]), p[1]), (w1, w2),
            jnp.asarray(vol.transpose(0, 2, 3, 4, 1)), jm, halo=2)
        want = np.asarray(want).transpose(0, 4, 1, 2, 3)
    finally:
        jax.config.update("jax_enable_x64", False)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # the unsharded tower, the seam included, one receptive field (2
    # voxels) away from the volume's ends (the function's DOMAIN note)
    import torch.nn.functional as F

    whole = F.conv3d(F.conv3d(torch.from_numpy(vol),
                              torch.from_numpy(w1), padding=1),
                     torch.from_numpy(w2), padding=1).numpy()
    np.testing.assert_allclose(got[:, :, 2:-2], whole[:, :, 2:-2], atol=TOL)
    assert np.abs(got[:, :, :2] - whole[:, :, :2]).max() > 1e-3


def test_level_layout():
    """The degenerate-level rule of the space-sharded UNet at 48^3 over 2
    and 4 slabs, at 220^3 over 2, on a volume too thin to split and at
    64^3 over 2."""
    from brainfm_tpu_torch.parallel.spatial import level_layout

    assert level_layout(48, 2, 6) == [True, True, True, False, False, False]
    assert level_layout(48, 4, 6) == [True, True, False, False, False, False]
    assert level_layout(220, 2, 6) == [True, True, False, False, False,
                                       False]
    assert level_layout(6, 2, 3) == [False, False, False]
    assert level_layout(64, 2, 5) == [True, True, True, True, False]


@pytest.fixture(scope="module")
def jax_gn():
    """`_fused_groupnorm` of td.gn_case()'s whole tensor under x64: the
    output, dx, dscale and dbias, NCDHW."""
    from brainfm_tpu.models import unet3d as u3

    x, scale, bias, gy = td.gn_case()
    jax.config.update("jax_enable_x64", True)
    try:
        y, vjp = jax.vjp(lambda a, s, b: u3._fused_groupnorm(a, s, b, 8),
                         jnp.asarray(np.moveaxis(x, 1, -1)),
                         jnp.asarray(scale), jnp.asarray(bias))
        dx, ds, db = vjp(jnp.asarray(np.moveaxis(gy, 1, -1)))
        return {"gn_y": np.moveaxis(np.asarray(y), -1, 1),
                "gn_dx": np.moveaxis(np.asarray(dx), -1, 1),
                "gn_dscale": np.asarray(ds), "gn_dbias": np.asarray(db)}
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("what,tol", [("gn_y", GN_VAL_TOL),
                                      ("gn_dx", GN_GRAD_TOL),
                                      ("gn_dscale", GN_GRAD_TOL),
                                      ("gn_dbias", GN_GRAD_TOL)])
def test_slab_group_norm_matches_jax(ranks, jax_gn, what, tol):
    """Each rank's fp64 slab through fused_group_norm with the space
    group: the slabs' outputs and dx concatenated on D against the whole
    tensor's; the scale's and bias's gradients summed over the ranks (each
    rank holds its slab's share, as the train step sums them)."""
    if what in ("gn_y", "gn_dx"):
        got = torch.cat([r[what] for r in ranks], dim=2)
    else:
        got = sum(r[what] for r in ranks)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), jax_gn[what], rtol=0, atol=tol)


@pytest.mark.parametrize("via", ["fn", "layer"])
def test_slab_group_norm_bf16_matches_the_unsharded(ranks, via):
    """A bf16 slab's GroupNorm stays bf16, through the function and
    through a SingleConv in a space scope under autocast, and agrees with
    the unsharded function of the whole tensor, sliced: within one bf16
    ulp, or 1e-5 where the fp32 value near 0 rounds to neighbours finer
    than that (the fp32 statistics differ in their last bits: the slabs'
    sums are added in another order), the rule of
    tests/test_torch_cuda.py::test_bf16_group_norm_on_the_card_matches_the_cpu."""
    for r in ranks:
        got, want = r[f"gn_bf16_{via}"], r["gn_bf16_want"]
        assert got.dtype == want.dtype == torch.bfloat16
        assert got.shape == want.shape == (2, 16, 4, 6, 10)
        ulp = 2.0 ** -7 * torch.maximum(got.float().abs(), want.float().abs())
        err = (got.float() - want.float()).abs()
        assert bool((err <= ulp + 1e-5).all()), float((err - ulp).max())
