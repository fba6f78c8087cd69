"""The sep variant (sep.yaml on twostage.yaml's generator: UNet3DSep with
the SepJoiner), DepHead and UNet2D against the JAX package on the CPU at
fp64, weights handed across by from_jax_params: the SepJoiner's outputs
(both feature pyramids, the normal and pathology heads), its state dict's
names, and one AdamW train step (monolithic and with sample_accum 2)
against the JAX package's jitted make_train_step; DepHead's and UNet2D's
outputs. Models are cut to f_maps 8 and 3 levels; the sep JAX reference at
32^3 is built once for the module."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brainfm_tpu.models.heads import DepHead as JDepHead
from brainfm_tpu.models.unet3d import UNet2D as JUNet2D
from brainfm_tpu_torch.models import DepHead, UNet2D, from_jax_params

from _torch_variants_util import (ATOL, LEVELS, check_forward,  # noqa: F401
                                  check_round_trip, check_step, variant_ref,
                                  x64)

NAME = "sep"


@pytest.fixture(scope="module")
def ref():
    return variant_ref(NAME)


@pytest.mark.parametrize("name,size", [("sep", 32)])
def test_variant_forward_matches_jax(ref, name, size):
    """Every output and feature level of the SepJoiner, before and after
    the processors."""
    check_forward(name, size, ref)


@pytest.mark.parametrize("name", [NAME])
def test_variant_params_round_trip(name):
    check_round_trip(name)


def test_dephead_matches_jax():
    """DepHead: the image concatenated to the last feature, two ConvBlocks
    and the fused 1x1 convs."""
    rng = np.random.default_rng(7)
    feats = [rng.standard_normal((2, 6, 5, 7, 8))]
    image = rng.standard_normal((2, 6, 5, 7, 1))
    out_ch = {"T1": 1, "segmentation": 5, "age": -1}
    jh = JDepHead((8, 8, 4), out_ch, compute_dtype=jnp.float64)
    p = jh.init(jax.random.PRNGKey(1), [jnp.asarray(f) for f in feats],
                jnp.asarray(image))
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), p)
    want = jax.jit(jh.apply)(p, [jnp.asarray(f) for f in feats],
                             jnp.asarray(image))
    head = DepHead(8, (8, 8, 4), out_ch).double()
    sd = from_jax_params({"head": p["params"]})
    head.load_state_dict({k.removeprefix("head."): v for k, v in sd.items()},
                         strict=True)
    with torch.no_grad():
        got = head([torch.from_numpy(f).movedim(-1, 1) for f in feats],
                   torch.from_numpy(image).movedim(-1, 1))
    assert set(got) == set(want) == {"T1", "segmentation"}
    for k in want:
        np.testing.assert_allclose(got[k].movedim(1, -1).numpy(),
                                   np.asarray(want[k]), atol=ATOL, err_msg=k)


@pytest.mark.parametrize("hw", [(32, 32), (33, 30)])
def test_unet2d_matches_jax(hw):
    """UNet2D (2-D convs, pools and upsampling) at every feature level,
    even and odd extents."""
    x = np.random.default_rng(2).standard_normal((2, *hw, 1))
    jm = JUNet2D(f_maps=8, num_levels=LEVELS, compute_dtype=jnp.float64)
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), p)
    want = jax.jit(lambda q, a: jm.apply(q, a, method=jm.get_feature))(
        p, jnp.asarray(x))
    model = UNet2D(f_maps=8, num_levels=LEVELS).double()
    sd = from_jax_params({"backbone": p["params"]})
    model.load_state_dict({k.removeprefix("backbone."): v
                           for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = model.get_feature(torch.from_numpy(x).movedim(-1, 1))
    assert len(got) == len(want) == LEVELS
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.movedim(1, -1).numpy(), np.asarray(b),
                                   atol=ATOL)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name", [NAME])
def test_variant_step_matches_jax(ref, name, accum):
    """One fp64 AdamW step, monolithic and in 2 sample microbatches:
    metrics rtol 1e-10, params rel-L2 < 1e-9 per tensor."""
    check_step(ref, name, accum)
