"""The output check refuses a broken timed path and the lower-precision
control, at the tiny size on the CPU: each run goes through the harness
with the program broken underneath, and `correct` comes out false, with
the number that the fault should move over its limit."""

from __future__ import annotations

import torch

from brainbench import check
from brainbench.drivers import train as tr
from brainbench.tests.tiny import execute, tiny_cell


def over(res, name):
    v = res["checks"][name]
    return not v["value"] <= v["limit"]


def test_train_step_that_leaves_the_state_unchanged(monkeypatch):
    from brainfm_tpu_torch.train import step as st

    def unchanged(state, total, losses, lr, wd, clip, mesh=None):
        state.optimizer.zero_grad(set_to_none=True)
        m = {k: v.detach() for k, v in losses.items()}
        m["loss_total"] = torch.as_tensor(total).detach()
        m["skipped"] = torch.tensor(0.0)
        return state, m

    monkeypatch.setattr(st, "_finite_update", unchanged)
    res = execute("joint.train")
    assert not res["correct"] and over(res, "update_gap")


def test_train_half_of_the_batch_left_out(monkeypatch):
    from brainfm_tpu_torch.train import step as st

    orig = st.batch_losses

    def half(model, cfg, loss_fn, batch, *args, **kwargs):
        S = batch["samples"]["input"].shape[1]
        b = dict(batch)
        b["samples"] = {k: v[:, :S // 2] for k, v in batch["samples"].items()}
        return orig(model, cfg, loss_fn, b, *args, **kwargs)

    monkeypatch.setattr(st, "batch_losses", half)
    res = execute("joint.train")
    assert not res["correct"] and (over(res, "loss_gap")
                                   or over(res, "grad_gap_median"))


def test_train_item_altered_where_it_is_made(monkeypatch):
    from brainfm_tpu_torch.train import loop

    orig = loop.make_batch

    def altered(*args, **kwargs):
        b = orig(*args, **kwargs)
        b["samples"]["input"][..., 5, 5, 5, :] += 0.5
        return b

    monkeypatch.setattr(loop, "make_batch", altered)
    res = execute("sep.train")
    assert not res["correct"] and over(res, "batch_gap")


def test_serve_label_altered_where_it_is_made(monkeypatch):
    from brainfm_tpu_torch.infer import api

    orig = api.postprocess

    def altered(*args, **kwargs):
        out = orig(*args, **kwargs)
        out["label"][:, :8] = 0
        return out

    monkeypatch.setattr(api, "postprocess", altered)
    res = execute("joint.serve")
    assert not res["correct"] and over(res, "label_miss")


def test_serve_head_altered_where_it_is_made(monkeypatch):
    from brainfm_tpu_torch.infer import api

    orig = api.postprocess

    def altered(*args, **kwargs):
        out = orig(*args, **kwargs)
        out["T1"] = out["T1"] * 1.5
        return out

    monkeypatch.setattr(api, "postprocess", altered)
    res = execute("joint.serve")
    assert not res["correct"] and over(res, "head_gap")


def test_train_control_fails_the_limits():
    """The reference in fp8 put in the program's place."""
    cell = tiny_cell("joint.train")
    dev = torch.device("cpu")
    seed = 12345678901
    subjects = tr.make_subjects(cell.traffic, seed, dev)
    order = tr.subject_order(seed, len(subjects), tr.CHECK_STEPS)
    args = (cell.config["cfg"], cell.traffic, seed, dev, subjects, order)
    ref, _ = tr.reference_steps(*args)
    ctl, _ = tr.reference_steps(*args, quant="fp8")
    ok, table = check.judge(check.train_checks(ctl, ref, [0.0]),
                            cell.limits)
    assert not ok, table


def test_serve_control_fails_the_limits(tmp_path):
    from brainbench.drivers import serve as sv

    cell = tiny_cell("joint.serve")
    dev = torch.device("cpu")
    seed = 12345678901
    win = tuple(cell.traffic["win"])
    path = sv.make_inputs(cell.traffic, seed, dev, str(tmp_path))[0]
    im, ro = sv.reference_outputs(*sv.reference(cell.config["cfg"], seed,
                                                dev), path, win)
    qim, qo = sv.reference_outputs(*sv.reference(cell.config["cfg"], seed,
                                                 dev, quant="fp8"), path, win)
    got = sv.compare(qim.to(torch.bfloat16).float(), qo,
                     qo["label"].numpy(), im, ro)
    ok, table = check.judge(check.serve_checks([got]), cell.limits)
    assert not ok, table
