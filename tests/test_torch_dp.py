"""The data-parallel train step of the port (train/step.py with a mesh, as
the benchmark's `joint.train_dp4` cell runs it over NCCL) on spawned gloo
CPU ranks at fp64: the mesh step over 2 ranks, each on its own items,
against one process over the union of the items and against the plain
reference of the benchmark (brainbench/reference/) on the same seeded
weights; the step's `step.reduce` span and its counters; the loss-name
check without an object collective; and the card a spawned rank takes
(parallel/mesh.py::init_distributed). No JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dp.py -q
"""

import copy

import pytest
import torch

from brainfm_tpu_torch.parallel import mesh as pm
from brainfm_tpu_torch.train import step as st
from brainfm_tpu_torch.utils import profiling

import _torch_dist as td

WORLD = 2
# fp64 on both sides with the same operations: the mesh adds the ranks'
# per-item losses and gradients in another order (read 1 ulp and 6e-16)
MESH_RTOL = 1e-12
# the port against the plain reference at fp64: the port's GroupNorm
# forms its statistics from one-pass sums where F.group_norm centres
# first, and the criterion associates its means otherwise (read 2 ulp on
# the loss, 8.5e-13 and 9.3e-14 relative L2 on the worst leaf's gradient
# and update)
REF_LOSS_RTOL = 1e-12
REF_RTOL = 1e-10


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return td.run("dp_step", WORLD, tmp_path_factory.mktemp("dp"))


@pytest.fixture(scope="module")
def single():
    """One process, no mesh, over the union batches (2 x WORLD items)."""
    tree = td.dp_tree()
    cfg, model, w, fn, opt = td.dp_port(tree)
    w0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = st.make_train_step(model, cfg, w, fn, opt)
    state = st.TrainState(model, opt, 0)
    out = {"losses": [], "counts": []}
    for g, batch in enumerate(td.dp_batches(tree, items=2 * WORLD)):
        with profiling.recording():
            state, met = step(state, batch, td.DP_LR, td.DP_WD)
        out["losses"].append(float(met["loss_total"]))
        out["counts"].append(dict(profiling.COUNTS))
        if g == 0:
            out["grads"] = td.adam_grads(model, opt)
    out["update"] = {n: p.detach() - w0[n]
                     for n, p in model.named_parameters()}
    return out


@pytest.fixture(scope="module")
def reference():
    """The plain reference's steps over the same batches, as the benchmark
    takes them (drivers/train.py::reference_steps): one sample at a time,
    each item's loss over the batch's samples, AdamW."""
    from brainbench import inputs
    from brainbench.reference import criterion as rc
    from brainbench.reference import model as rm

    tree = td.dp_tree()
    cfg, model = rm.build_model(rm.Cfg.from_nested(copy.deepcopy(tree)),
                                "cpu")
    inputs.load_weights(model, inputs.seed_weights(
        inputs.weight_specs(model), td.DP_SEED, "cpu"))
    model.double().train()
    _, wdict, loss_fn = rc.make_criterion(cfg)
    opt = torch.optim.AdamW(model.parameters(), lr=td.DP_LR,
                            weight_decay=td.DP_WD, foreach=False)
    w0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    out = {"losses": []}
    for g, batch in enumerate(td.dp_batches(tree, items=2 * WORLD)):
        opt.zero_grad(set_to_none=True)
        B, S = batch["samples"]["input"].shape[:2]
        total = 0.0
        for b in range(B):
            tb = {k: v[b] for k, v in batch["targets"].items()}
            for s in range(S):
                o = rm.apply_processors(
                    model(batch["samples"]["input"][b, s:s + 1]), cfg)
                sb = {k: v[b, s:s + 1] for k, v in batch["samples"].items()}
                t = rc.weighted_total(loss_fn(o, tb, sb), wdict) / (S * B)
                t.backward()
                total += float(t.detach())
        out["losses"].append(total)
        if g == 0:
            out["grads"] = {n: (torch.zeros_like(p) if p.grad is None
                                else p.grad.clone())
                            for n, p in model.named_parameters()}
        opt.step()
    out["update"] = {n: p.detach() - w0[n]
                     for n, p in model.named_parameters()}
    return out


def _rel(a, b):
    """Each leaf's |a - b| / |b| (L2; 0 where both are 0)."""
    out = {}
    for k in b:
        den, num = float(b[k].norm()), float((a[k] - b[k]).norm())
        out[k] = num / den if den else num
    return out


def test_mesh_step_equals_one_process_over_the_union(ranks, single):
    """Every rank reads the world's mean loss, holds the same summed
    gradient and makes the same update as one process over all items."""
    for r in ranks:
        assert r["losses"] == pytest.approx(single["losses"],
                                            rel=MESH_RTOL)
        assert max(_rel(r["grads"], single["grads"]).values()) <= MESH_RTOL
        assert max(_rel(r["update"], single["update"]).values()) \
            <= MESH_RTOL
    for k, v in ranks[0]["update"].items():
        assert torch.equal(v, ranks[1]["update"][k]), k


def test_both_against_the_plain_reference(ranks, single, reference):
    """The update is compared on the leaves the reference's gradient
    moves, by brainbench/check.py's rule: a leaf the losses do not reach
    (the head of a task without a target in these items) gets a zero
    gradient in the port, which AdamW decays, and none in the
    reference, which AdamW skips."""
    from brainbench.check import moved_leaves

    moved = moved_leaves({n: float(g.norm())
                          for n, g in reference["grads"].items()})
    assert 0 < len(moved) < len(reference["grads"])
    for side in (single, ranks[0], ranks[1]):
        assert side["losses"] == pytest.approx(reference["losses"],
                                               rel=REF_LOSS_RTOL)
        assert max(_rel(side["grads"], reference["grads"]).values()) \
            <= REF_RTOL
        upd = _rel(side["update"], reference["update"])
        assert max(upd[n] for n in moved) <= REF_RTOL
        # the leaves left out are those with no gradient at all
        assert all(float(reference["grads"][n].norm()) == 0
                   for n in set(upd) - moved)


def test_a_recorded_mesh_step_has_one_reduce_span_and_counts_it(ranks,
                                                                 single):
    """Each step: one `step.reduce` span holding the losses' all-reduce
    (`step.reduce.wait`, where a rank waits for the slowest) and after it
    the one gradient bucket's (`step.reduce.grads`), the gradients' bytes
    in `reduce.bytes`, three collectives (the gradient bucket, the
    losses, the non-finite flag) and one more at the first step (the
    loss-name check), whose host sync is counted: the same syncs as one
    process plus that one."""
    for r in ranks:
        assert r["reduce_spans"] == [["step.reduce", "step.reduce.wait",
                                      "step.reduce.grads"]] * 2
        c0, c1 = r["counts"]
        assert c0["reduce.bytes"] == c1["reduce.bytes"] == r["grad_bytes"]
        assert (c0["collectives"], c1["collectives"]) == (4, 3)
        s0, s1 = (c.get("host_syncs", 0) for c in single["counts"])
        assert (c0["host_syncs"], c1["host_syncs"]) == (s0 + 1, s1)
        assert "collectives" not in single["counts"][0]


def test_the_loss_names_are_checked_without_object_collectives(ranks):
    """No all_gather_object in any step; ranks whose items give different
    losses both raise."""
    for out in ranks:
        assert out["objects"] == [0, 0]
        assert out["names_error"].startswith(
            "the ranks' items give different losses")


@pytest.mark.parametrize("env,process_id,count,card", [
    ({}, 6, 4, 2), ({}, 3, 4, 3), ({"LOCAL_RANK": "1"}, 6, 4, 1),
    ({}, 0, 1, 0)])
def test_a_spawned_rank_takes_its_own_card(monkeypatch, env, process_id,
                                           count, card):
    """A process given its id on a single host takes card id % cards
    when LOCAL_RANK is unset, LOCAL_RANK's card when it is set."""
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = {}
    monkeypatch.setattr(pm.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(pm.dist, "init_process_group",
                        lambda **kw: seen.update(kw))
    monkeypatch.setattr(pm.dist, "get_rank", lambda: seen["rank"])
    monkeypatch.setattr(pm.dist, "get_world_size",
                        lambda: seen["world_size"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: seen.setdefault("card", d))
    assert pm.init_distributed("localhost:29500", 8, process_id,
                               backend="nccl") == (process_id, 8)
    assert seen["card"] == card
    assert seen["init_method"] == "tcp://localhost:29500"

