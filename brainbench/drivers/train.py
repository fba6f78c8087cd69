"""The training driver: one client in a closed loop, each iteration one
batch of items synthesized on the card and one train step.

The traffic file gives the subject bank (`subjects`, `extent`,
`bank_shape`, `lesions`), `batch_items` and `itr_per_epoch`, the length of
the schedule's epoch. Each iteration is what the port's `train()` makes:
`train/loop.py::make_batch` with one generator per item over a bank
subject, then the step of `train/step.py::make_train_step` at the
schedule's learning rate and weight decay (`train/schedules.py`). The
subjects, their order and the items' generators are drawn from the seed
by the benchmark; no validation or checkpoint runs.

Set-up builds the one training object (model, optimizer state, step) with
weights from the seed and drives it through its first `CHECK_STEPS`
iterations, which also warm every shape. From them it keeps what the
output check needs: each step's loss, the first gradient as AdamW holds it
(its first moment over 1 - beta1), the parameters' change over the steps
and the synthesized batches (on the host). The same object then runs the
window. Once the window has closed and the program is freed, the plain
reference (`brainbench/reference`) makes the same batches from the same
subjects and generators and takes the same steps in float32 with TF32 off.

A training cell of another model or launch is a driver module of its own
that names its parts, `PROGRAM` (this module's `Program` or a subclass
that builds its step otherwise, `Program.make_step`) and `REFERENCE` (a
`Reference`: the plain model's builder, processors and criterion), and
hands them to `run`; this module's are the UNet3D and UNet3D-Sep ones.
"""

from __future__ import annotations

import copy
import gc
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .. import check, inputs
from ..record import Outcome, Spans, Window, log
from ..reference import criterion as rc
from ..reference import model as rm

CHECK_STEPS = 3
_ITEMS = 4       # the item generators' stream of inputs.generator


@dataclass
class StepRecord:
    """One side's first steps: losses, the first gradient's norm per leaf,
    the parameters' change per leaf after the last step."""
    losses: list
    grad_norms: dict
    update_norms: dict


@dataclass(frozen=True)
class Reference:
    """A training cell's plain reference model: `build_model(cfg, device)
    -> (cfg, model)` of a `reference.model.Cfg`, float32; `apply_processors
    (out, cfg)` on its raw outputs; `make_criterion(cfg) -> (_, weight
    dict, loss_fn)`."""
    build_model: Callable
    apply_processors: Callable
    make_criterion: Callable


REFERENCE = Reference(rm.build_model, rm.apply_processors, rc.make_criterion)


def subject_order(seed: int, n_subjects: int, count: int) -> list:
    """The bank subject of each iteration, drawn from the seed."""
    rng = np.random.default_rng((int(seed) % 2 ** 64, 17))
    return [int(i) for i in rng.integers(n_subjects, size=count)]


def item_generators(seed, gstep, batch_items, device):
    return [inputs.generator(seed, _ITEMS, device, gstep * batch_items + i)
            for i in range(batch_items)]


def make_subjects(traffic, seed, device):
    return [inputs.label_subject(seed, i, traffic["extent"],
                                 traffic["bank_shape"], device,
                                 lesion=bool(traffic.get("lesions")))
            for i in range(int(traffic["subjects"]))]


def _norms(named) -> dict:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in named}


def _update_norms(model, w0) -> dict:
    return {n: float(torch.linalg.vector_norm((p.detach() - w0[n]).double()))
            for n, p in model.named_parameters()}


def _host(batch):
    return {k: ({kk: vv.cpu() for kk, vv in v.items()}
                if isinstance(v, dict) else v)
            for k, v in batch.items() if k in ("samples", "targets")}


class Program:
    """The port's training object and its feed. `batch_items`: the items
    one step holds (the reference takes as many)."""

    def __init__(self, cfg_tree, traffic, seed, device, subjects):
        from brainfm_tpu_torch.config import AttrDict
        from brainfm_tpu_torch.models import build_model
        from brainfm_tpu_torch.models.criterion import make_criterion
        from brainfm_tpu_torch.synth import (SubjectBank, SynthStatic,
                                             knobs_from_cfg)
        from brainfm_tpu_torch.train.schedules import build_schedules
        from brainfm_tpu_torch.train.step import TrainState, build_optimizer

        self.dev, self.seed = device, seed
        cfg, model = build_model(AttrDict.from_nested(copy.deepcopy(
            cfg_tree)), device=device)
        self.specs = inputs.weight_specs(model)
        inputs.load_weights(model, inputs.seed_weights(self.specs, seed,
                                                       device))
        _, wdict, loss_fn = make_criterion(cfg)
        opt = build_optimizer(cfg, model.parameters())
        self.step_fn = self.make_step(model, cfg, wdict, loss_fn, opt)
        self.state = TrainState(model, opt, 0)
        self.cfg = cfg
        self.scfg = SynthStatic.from_cfg(cfg)
        self.tasks = tuple(cfg.tasks)
        self.knobs = knobs_from_cfg(cfg, self.scfg, "synth")
        self.bank = SubjectBank(tuple(traffic["bank_shape"]))
        self.bank.subjects.extend(subjects)
        for i in range(len(self.bank)):      # every subject on the card
            self.bank.to_device(i, device)
        self.batch_items = int(traffic["batch_items"])
        self.lr, self.wd = build_schedules(cfg, int(traffic["itr_per_epoch"]))

    def make_step(self, model, cfg, wdict, loss_fn, opt):
        """The step of `train/step.py::make_train_step`; a subclass passes
        `critic=`, `train_stage0=` or `mesh=` here."""
        from brainfm_tpu_torch.train.step import make_train_step

        return make_train_step(
            model, cfg, wdict, loss_fn, opt,
            sample_accum=int(cfg.get("grad_accum_samples") or 1))

    def batch(self, gstep, subject):
        from brainfm_tpu_torch.train.loop import apply_condition, make_batch

        b = make_batch(item_generators(self.seed, gstep, self.batch_items,
                                       self.dev),
                       self.bank.to_device(subject, self.dev), self.scfg,
                       self.tasks, "synth", self.knobs)
        return apply_condition(b, self.cfg.get("condition"))

    def step(self, gstep, batch):
        i = min(gstep, len(self.lr) - 1)
        self.state, metrics = self.step_fn(self.state, batch,
                                           float(self.lr[i]),
                                           float(self.wd[i]))
        return metrics

    def first_grad_norms(self) -> dict:
        """Each leaf's first gradient as AdamW holds it (0 for a leaf it
        holds no moment of)."""
        opt = self.state.optimizer
        beta1 = opt.param_groups[0]["betas"][0]
        return {n: float(torch.linalg.vector_norm(
            opt.state[p]["exp_avg"].double())) / (1.0 - beta1)
            if "exp_avg" in opt.state.get(p, {}) else 0.0
            for n, p in self.state.model.named_parameters()}

    def free(self):
        del self.state, self.step_fn, self.bank
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


PROGRAM = Program


def first_steps(prog, order, seed):
    """The program's first CHECK_STEPS iterations through the window's own
    calls: (StepRecord, the batches on the host, the seconds spent on the
    check's bookkeeping, each iteration's seconds on the host clock up to
    its loss read back)."""
    dev, check_s = prog.dev, 0.0
    batches, losses, step_s = [], [], []
    for g in range(CHECK_STEPS):
        t0 = time.perf_counter()
        batch = prog.batch(g, order[g])
        t = time.perf_counter()
        batches.append(_host(batch))
        check_s += time.perf_counter() - t
        metrics = prog.step(g, batch)
        del batch
        losses.append(float(metrics["loss_total"]))
        step_s.append(time.perf_counter() - t0)
        if g == 0:
            t = time.perf_counter()
            grad_norms = prog.first_grad_norms()
            check_s += time.perf_counter() - t
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t = time.perf_counter()
    w0 = inputs.seed_weights(prog.specs, seed, dev)
    rec = StepRecord(losses, grad_norms, _update_norms(prog.state.model, w0))
    del w0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    return rec, batches, check_s + time.perf_counter() - t, step_s


def reference_steps(cfg_tree, traffic, seed, device, subjects, order,
                    quant=None, prog_batches=None, samples=None,
                    reference=REFERENCE, items=None):
    """The plain reference's first CHECK_STEPS steps on the same subjects
    and generators: (StepRecord, batch gaps against `prog_batches`).
    `quant` as reference.model.set_arithmetic; `samples` keeps only the
    first that many samples of each item (a planted fault: the rest of
    the batch left out); `reference`: the plain model (a `Reference`);
    `items`: the items a step holds (the traffic's `batch_items`)."""
    from ..reference.synth.batch import stack_items
    from ..reference.schedules import build_schedules
    from ..reference.synth.engine import knobs_from_cfg, synth_item
    from ..reference.synth.params import SynthStatic

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg, model = reference.build_model(rm.Cfg.from_nested(copy.deepcopy(
            cfg_tree)), device)
        if cfg.get("condition"):
            raise ValueError("the reference has no conditioned inputs")
        w0 = inputs.seed_weights(inputs.weight_specs(model), seed, device)
        inputs.load_weights(model, w0)
        rm.set_arithmetic(model, quant, checkpointed=True)
        model.train()
        _, wdict, loss_fn = reference.make_criterion(cfg)
        scfg = SynthStatic.from_cfg(cfg)
        knobs = knobs_from_cfg(cfg, scfg, "synth")
        lr, wd = build_schedules(cfg, int(traffic["itr_per_epoch"]))
        opt = torch.optim.AdamW(model.parameters(), lr=float(lr[0]),
                                weight_decay=float(wd[0]), foreach=False)
        B = int(traffic["batch_items"] if items is None else items)
        losses, gaps, grad_norms = [], [], None
        for g in range(CHECK_STEPS):
            subj = {k: torch.as_tensor(v).to(device)
                    for k, v in subjects[order[g]].items()}
            items = [synth_item(gen, subj, scfg, tuple(cfg.tasks), "synth",
                                knobs)
                     for gen in item_generators(seed, g, B, device)]
            batch = stack_items([t for t, _ in items], [s for _, s in items])
            del items, subj
            if prog_batches is not None:
                gaps.append(check.batch_gap(prog_batches[g], batch))
            opt.zero_grad(set_to_none=True)
            total = 0.0
            S = batch["samples"]["input"].shape[1]
            S = min(S, samples or S)
            for b in range(B):
                tb = {k: v[b] for k, v in batch["targets"].items()}
                for s in range(S):
                    out = model(batch["samples"]["input"][b, s:s + 1])
                    out = reference.apply_processors(out, cfg)
                    sb = {k: v[b, s:s + 1]
                          for k, v in batch["samples"].items()}
                    t = rc.weighted_total(loss_fn(out, tb, sb), wdict)
                    (t / (S * B)).backward()
                    total += float(t.detach()) / (S * B)
                    del out, t
            losses.append(total)
            if g == 0:
                grad_norms = _norms(
                    (n, torch.zeros_like(p) if p.grad is None else p.grad)
                    for n, p in model.named_parameters())
            for group in opt.param_groups:
                group["lr"] = float(lr[min(g, len(lr) - 1)])
                group["weight_decay"] = float(wd[min(g, len(wd) - 1)])
            opt.step()
            del batch
        rec = StepRecord(losses, grad_norms, _update_norms(model, w0))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    return rec, gaps


def run(cell, seed, seconds, trace, device, clock, program=Program,
        reference=REFERENCE):
    """One run of a training cell; `clock()` gives the seconds since the
    process started. `program`: the class of the training object (as
    `Program`); `reference`: the plain model it is held to."""
    from ..trace import Timeline, device_trace

    traffic, cfg_tree = cell.traffic, cell.config["cfg"]
    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    # the set-up's parts, on the host clock between calls (no sync)
    t_driver = clock()
    subjects = make_subjects(traffic, seed, dev)
    t_subjects = clock()
    prog = program(cfg_tree, traffic, seed, dev, subjects)
    t_program = clock()
    horizon = CHECK_STEPS + 100_000
    order = subject_order(seed, len(subjects), horizon)

    # set-up: the first steps through the window's own calls
    prog_rec, batches, check_s, step_s = first_steps(prog, order, seed)
    t_steps = clock()
    setup_s = t_steps - check_s

    # the window
    failed = 0
    spans = Spans(bool(trace), sync)
    B = prog.batch_items
    g = CHECK_STEPS
    with device_trace(bool(trace) and dev.type == "cuda") as tr:
        sync()
        t0_ns, t0 = time.time_ns(), time.perf_counter()
        while True:
            with spans("item"):
                batch = prog.batch(g, order[g])
            with spans("step"):
                metrics = prog.step(g, batch)
            del batch
            failed += int(float(metrics["skipped"]) > 0)
            g += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        elapsed, t1_ns = time.perf_counter() - t0, time.time_ns()
    steps = g - CHECK_STEPS
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    timeline = (Timeline(tr.events, t0_ns, t1_ns, spans.spans)
                if tr.events is not None else None)
    window = Window(seconds=elapsed, done=steps * B, cfg=cfg_tree,
                    traffic=traffic, spans=spans, timeline=timeline)
    prog.free()
    del prog

    t = time.perf_counter()
    ref_rec, gaps = reference_steps(cfg_tree, traffic, seed, dev, subjects,
                                    order, prog_batches=batches,
                                    reference=reference, items=B)
    checks = check.train_checks(prog_rec, ref_rec, gaps)
    log(f"set-up {setup_s:.2f} s (check bookkeeping {check_s:.2f} s more), "
        f"window {elapsed:.2f} s, {steps} steps, reference "
        f"{time.perf_counter() - t:.2f} s; losses {prog_rec.losses} "
        f"against {ref_rec.losses}")
    log(f"set-up parts: to the driver {t_driver:.3f} s, subjects "
        f"{t_subjects - t_driver:.3f} s, build and weights "
        f"{t_program - t_subjects:.3f} s, first {CHECK_STEPS} steps "
        f"{t_steps - t_program - check_s:.3f} s (each with its bookkeeping "
        f"{', '.join(f'{s:.3f}' for s in step_s)} s); check bookkeeping "
        f"{check_s:.3f} s, not in set-up")
    return Outcome(end_to_end={"setup_s": setup_s,
                               "train_items_per_s": steps * B / elapsed},
                   window=window, attempted=steps * B, failed=failed * B,
                   memory_peak_bytes=int(peak), checks=checks)
