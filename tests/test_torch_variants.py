"""The pooled age head's model (joint_age.yaml with brain_id_age.yaml)
against the JAX package on the CPU at fp64, weights handed across by
from_jax_params: every output on an even and an odd volume, the state
dict's round trip through the JAX package's reader, and one AdamW train
step (monolithic and with sample_accum 2) against the JAX package's jitted
make_train_step. The model is cut to f_maps 8 and 3 levels; the JAX
reference at 32^3 is built once for the module. The sep variant, DepHead
and UNet2D are in tests/test_torch_variant_sep.py, the critic in
tests/test_torch_variant_critic.py."""

import pytest

from _torch_variants_util import (check_forward, check_round_trip,
                                  check_step, variant_ref, x64)  # noqa: F401

NAME = "joint_age"


@pytest.fixture(scope="module")
def ref():
    return variant_ref(NAME)


@pytest.mark.parametrize("name,size", [("joint_age", 32), ("joint_age", 36)])
def test_variant_forward_matches_jax(ref, name, size):
    """Every output and feature level of the age model (36^3: the pools'
    floors, 36 -> 9 -> 2), before and after the processors."""
    check_forward(name, size, ref)


@pytest.mark.parametrize("name", [NAME])
def test_variant_params_round_trip(name):
    check_round_trip(name)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name", [NAME])
def test_variant_step_matches_jax(ref, name, accum):
    """One fp64 AdamW step, monolithic and in 2 sample microbatches:
    metrics rtol 1e-10, params rel-L2 < 1e-9 per tensor."""
    check_step(ref, name, accum)
