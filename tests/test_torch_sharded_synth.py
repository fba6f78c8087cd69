"""Per-rank synthesis of the port (synth/sharded.py, SynthDataset's
get_group and get_batch_sharded) on two spawned gloo CPU ranks (data=2):
each rank's rows equal the same rows of a serial make_batch over the same
per-item generators, bitwise, for a shared subject, for per-item
subjects, and for the dataset stream's grouped batches over a procedural
data root (homogeneous and mixed-modality groups, lesions from the pool)."""

import pytest

import _torch_dist as td


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return td.run("sharded_synth", 2, tmp_path_factory.mktemp("synth"))


@pytest.mark.parametrize("case", ["shared", "per_item"])
def test_sharded_batch_is_serial_bitwise(ranks, case):
    for r in ranks:
        assert r[case] is True
    assert "T1" in ranks[0]["shared_keys"]


def test_get_batch_sharded_is_serial_bitwise(ranks):
    """Four grouped batches of 4 items: every rank's two items equal the
    serial draws; the modality roulette made both a single-mode and a
    mixed batch."""
    for r in ranks:
        assert [same for _, same in r["groups"]] == [True] * 4
    kinds = {len(modes) for modes, _ in ranks[0]["groups"]}
    assert kinds == {1, 2}, ranks[0]["groups"]
    assert ranks[0]["groups"] == ranks[1]["groups"]
    assert ranks[0]["lesions"] == 16   # every item drew one
