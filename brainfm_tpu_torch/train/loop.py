"""The training loop (port of brainfm_tpu/train/loop.py).

Per-iteration schedule lookup, per-step metrics with an epoch nanmean,
fixed-seed validation with best-checkpoint handling, the rolling epoch
checkpoint and the loss curve. Every item is synthesized on the model's
device by `synth_item`, so K1 (ops/warp.py) and K2 (ops/lut.py) run in
every iteration. Items come from a subject bank or from the
multi-dataset stream (synth/datasets.py::ConcatStream). Randomness is
drawn per epoch from (seed, epoch): a torch generator for the bank's items
(the stream's: one per item, from (seed, epoch, item)) and numpy generators
for the host draws, all made anew each epoch, so a run resumed at an epoch
boundary draws what an uninterrupted one draws.

Not ported here: the multi-GPU mesh and FSDP, two-stage training and the
periodic visualizer; each raises NotImplementedError.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models.build import build_critic_from_cfg
from ..models.criterion import weighted_total
from ..synth import SynthStatic, knobs_from_cfg, synth_item
from ..synth.batch import stack_items
from ..synth.datasets import item_generator
from ..synth.sampler import WeightedSubjectSampler, choose_modality
from ..utils.logging import plot_loss, setup_logging, write_log_line
from .checkpoint import (finalize_pending, load_checkpoint, read_extra,
                         save_best_checkpoint, save_checkpoint)
from .schedules import build_schedules
from .step import (TrainState, amp_enabled, batch_losses, build_optimizer,
                   make_train_step, split_samples)


def make_batch(generators, subject, scfg, tasks, input_mode, knobs):
    """Synthesize B items (one per generator; one generator may stand for
    several, drawn in turn) and stack them into a train batch."""
    targets, samples = [], []
    for g in generators:
        t, s = synth_item(g, subject, scfg, tasks, input_mode, knobs)
        targets.append(t)
        samples.append(s)
    return stack_items(targets, samples)


def apply_condition(batch, condition: str | None):
    """Mask/flip conditioning of a train batch: 'mask' zeroes the anomaly
    out of the input and conditions on the pathology target; 'flip'
    conditions on the sagittally flipped input; 'mask+flip' concatenates
    both."""
    if not condition:
        return batch
    samples = dict(batch["samples"])
    targets = batch["targets"]
    x = samples["input"]  # (B, S, D, H, W, C)
    cond = None
    if "mask" in condition:
        p = targets["pathology"].to(x.dtype)
        x = x * (1.0 - p)
        cond = torch.broadcast_to(p, x.shape)
    if "flip" in condition:
        xf = torch.flip(x, (2,))
        cond = xf if cond is None else torch.cat([xf, cond], dim=-1)
    samples["input"] = x
    out = dict(batch)
    out["samples"] = samples
    out["cond"] = cond
    return out


def make_eval_step(model, cfg, weight_dict, loss_fn, sample_accum: int = 1,
                   amp: bool | None = None):
    """Validation step `step(model, batch) -> losses` (with 'loss_total'):
    forward + criterion under torch.no_grad. `sample_accum`: the S-sample
    stack in sequential chunks whose losses are averaged (exact, as the
    train step's; skipped when it does not divide S)."""
    del model   # the caller passes the model to each call
    amp = amp_enabled(cfg, amp)
    k = int(sample_accum)

    @torch.no_grad()
    def step(model, batch):
        S = batch["samples"]["input"].shape[1]
        if k > 1 and S % k == 0 and S > 1:
            parts = [batch_losses(model, cfg, loss_fn,
                                  split_samples(batch, i, k), amp)
                     for i in range(k)]
            losses = {kk: torch.mean(torch.stack([p[kk] for p in parts]))
                      for kk in parts[0]}
        else:
            losses = batch_losses(model, cfg, loss_fn, batch, amp)
        losses["loss_total"] = torch.as_tensor(
            weighted_total(losses, weight_dict))
        return losses

    return step


def _to(batch, dev):
    """A batch's tensors on `dev`."""
    return {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                if isinstance(v, dict) else
                (None if v is None else v.to(dev)))
            for k, v in batch.items()}


def make_val_set(bank, scfg, tasks, input_modes, knobs, seed: int,
                 n_items: int = 2, batch_items: int = 1,
                 stage_host: bool = False, device=None):
    """A fixed-seed set of synthetic validation batches, the same across
    epochs and resumes. stage_host: subjects ship uncached
    (SubjectBank.stage) and the batches are kept in host memory; the
    caller ships each one back at validation time."""
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(100_000 + seed)
    rng = np.random.default_rng(seed + 7)
    batches = []
    for _ in range(n_items):
        i = int(rng.integers(len(bank)))
        subj = bank.stage(i, dev) if stage_host else bank.to_device(i, dev)
        mode = input_modes[int(rng.integers(len(input_modes)))]
        b = make_batch([gen] * batch_items, subj, scfg, tasks, mode,
                       knobs[mode])
        if stage_host:
            b = _to(b, "cpu")
        batches.append(b)
    return batches


# the sampler epoch of the stream's validation set, far outside any
# training epoch
VAL_EPOCH = 1_000_000_007


def make_val_set_stream(stream, seed: int, n_items: int = 2,
                        batch_items: int = 1, stage_host: bool = False):
    """Fixed-seed validation batches drawn across the stream's datasets
    with the training mixture's probabilities, the same across epochs and
    resumes: the sampler and every dataset's roulette are set to the epoch
    VAL_EPOCH + seed, and the items draw from generators of (100_000 +
    seed, VAL_EPOCH, item). Returns (batches, dataset_names)."""
    stream.sampler.set_epoch(VAL_EPOCH + seed)
    for n in stream.names:
        stream.datasets[n].reseed(VAL_EPOCH + seed)
    plan = stream.sampler.sample_grouped(n_items, batch_items)
    batches, item = [], 0
    for d, idxs in plan:
        ds = stream.datasets[stream.names[d]]
        items = []
        for i in idxs:
            items.append(ds.get(i, item_generator(100_000 + seed, VAL_EPOCH,
                                                  item, ds.device)))
            item += 1
        b = stack_items([t for t, _ in items], [s for _, s in items])
        batches.append(_to(b, "cpu") if stage_host else b)
    return batches, [stream.names[d] for d, _ in plan]


def epoch_generator(dev, seed: int, epoch: int) -> torch.Generator:
    """The item generator of one epoch, seeded from (seed, epoch) only."""
    s = np.random.SeedSequence((seed + 1, epoch)).generate_state(1, np.uint64)
    return torch.Generator(dev).manual_seed(int(s[0] >> np.uint64(1)))


def _bank_batch(bank, idx, dev, stage_host, input_prob, rng_host,
                input_modes, knobs, cfg, scfg, tasks, gen, batch_items):
    """One train batch from bank subject `idx`: its modality drawn from
    `input_prob` (or `input_modes`), then `batch_items` items. A staged
    subject is freed before the caller's step."""
    subj = bank.stage(idx, dev) if stage_host else bank.to_device(idx, dev)
    if input_prob:
        avail = set(bank.subjects[idx].keys())
        mode = choose_modality(rng_host, input_prob, avail)
        if mode != "synth" and mode in subj:
            subj = dict(subj)
            subj["image"] = subj[mode]
        if mode not in knobs:
            knobs[mode] = knobs_from_cfg(cfg, scfg, mode)
    else:
        mode = input_modes[rng_host.integers(len(input_modes))]
    return make_batch([gen] * batch_items, subj, scfg, tasks, mode,
                      knobs[mode])


def _refuse(what, why):
    raise NotImplementedError(
        f"{what} is not ported yet ({why}); the port trains on one device "
        "from a subject bank")


def train(cfg, model, weight_dict, loss_fn, bank, out_dir: str,
          itr_per_epoch: int = 100, batch_items: int = 1,
          input_modes=("synth",), seed: int = 0, log_itr: int = 10,
          resume: str | None = None, vis_itr: int = 0, val_itr: int = 1,
          n_val_items: int = 2, keep_ckpt: int = 2, stream=None, mesh=None,
          fsdp: bool = False, twostage_models=None):
    """Run the training loop on the model's device. `bank`: SubjectBank;
    `cfg`: the processed trainer config (with .generator etc.).

    `stream`: a synth/datasets.py ConcatStream (the multi-dataset
    registry: per-dataset banks, modality roulettes and probability
    mixing), in place of the bank's subject sampling; `bank` may then be
    None, and validation draws across the stream's datasets
    (make_val_set_stream).

    Every `val_itr` epochs the fixed-seed val set is scored; a new best
    val loss_total saves ckp/ckpt_best (the previous best renamed to
    ckpt_best_bk). `keep_ckpt` bounds the rolling epoch checkpoints
    (ckp/ckpt_{step}), saved on a background thread. Writes log.txt (one
    JSON line per epoch), train.log and the loss curve. Returns the
    TrainState."""
    if mesh is not None or fsdp:
        _refuse("mesh= / fsdp=True", "the multi-GPU slice, Queue 1 item 6")
    if twostage_models is not None:
        _refuse("twostage_models= (two-stage training)",
                "the pathology models, Queue 1 item 6")
    if vis_itr:
        _refuse("vis_itr > 0 (the training visualizer)",
                "utils/visualizer.py, Queue 1 item 6")
    build_critic_from_cfg(cfg)   # raises when losses.implicit_pathol is on

    os.makedirs(out_dir, exist_ok=True)
    logger = setup_logging(os.path.join(out_dir, "train.log"))
    dev = next(model.parameters()).device
    scfg = SynthStatic.from_cfg(cfg)
    tasks = tuple(cfg.tasks)
    optimizer = build_optimizer(cfg, model.parameters())
    state = TrainState(model, optimizer, 0)
    start_epoch = 0
    best_val_stats = None
    if resume:
        state = load_checkpoint(resume, state)
        extra = read_extra(resume)
        # the epoch a checkpoint closed is in its extras; state.step counts
        # applied updates only (a skipped step does not advance it)
        start_epoch = (int(extra["epoch"]) + 1 if "epoch" in extra
                       else state.step // itr_per_epoch)
        best_val_stats = extra.get("best_val_stats")
        logger.info(f"resumed from {resume} at epoch {start_epoch} "
                    f"(best_val_stats: {best_val_stats})")

    lr_sched, wd_sched = build_schedules(cfg, itr_per_epoch)
    stage_host = str(cfg.get("subject_staging") or "cache") == "host"
    if stage_host:
        logger.info("subject staging: host (uncached per-draw copy; no "
                    "bank residency during the train step)")
    sample_accum = int(cfg.get("grad_accum_samples") or 1)
    if sample_accum > 1:
        logger.info(f"gradient accumulation over the sample stack: "
                    f"{sample_accum} microbatches")
    step_fn = make_train_step(model, cfg, weight_dict, loss_fn, optimizer,
                              sample_accum=sample_accum)
    knobs = {m: knobs_from_cfg(cfg, scfg, m) for m in set(input_modes)}
    sampler = (WeightedSubjectSampler([len(bank)], seed=seed)
               if stream is None else None)
    input_prob = dict(cfg.get("input_prob") or {})
    if stream is None and not input_prob \
            and tuple(input_modes) == ("synth",):
        logger.info("input modes: synth only (no input_prob/modality table "
                    "configured)")

    n_epochs = int(cfg.n_epochs)
    stats: dict = {}
    val_batches = None  # built at the first validation epoch
    eval_step = None
    for epoch in range(start_epoch, n_epochs):
        gen = epoch_generator(dev, seed, epoch)
        rng_host = np.random.default_rng((seed, epoch))
        metric_hist: list = []
        t_ep = time.time()
        if stream is not None:
            item_iter = stream.epoch(epoch, itr_per_epoch * batch_items,
                                     seed)
        else:
            sampler.set_epoch(epoch)
            subj_plan = sampler.sample(itr_per_epoch)
        for it in range(itr_per_epoch):
            gstep = epoch * itr_per_epoch + it
            if stream is not None:
                items = [next(item_iter) for _ in range(batch_items)]
                batch = _to(stack_items([t for _, t, _ in items],
                                        [s for _, _, s in items]), dev)
                del items
            else:
                batch = _bank_batch(bank, subj_plan[it][1], dev, stage_host,
                                    input_prob, rng_host, input_modes, knobs,
                                    cfg, scfg, tasks, gen, batch_items)
            batch = apply_condition(batch, cfg.get("condition"))
            lr = float(lr_sched[min(gstep, len(lr_sched) - 1)])
            wd = float(wd_sched[min(gstep, len(wd_sched) - 1)])
            state, metrics = step_fn(state, batch, lr, wd)
            del batch
            metric_hist.append(metrics)
            if it % log_itr == 0:
                logger.info(f"epoch {epoch} it {it}/{itr_per_epoch} "
                            f"lr {lr:.2e} "
                            f"loss {float(metrics['loss_total']):.6g} "
                            f"skipped {int(metrics['skipped'])}")
        # nanmean: skipped steps report NaN losses and must not poison the
        # epoch averages; 'skipped' is 0/1, so its mean is the skip share
        stats = {f"train_{k}": float(torch.nanmean(torch.stack(
            [m[k].float() for m in metric_hist]))) for k in metric_hist[0]}
        stats.update({"epoch": epoch, "epoch_time": time.time() - t_ep})

        if val_itr and (epoch + 1) % val_itr == 0:
            if val_batches is None:
                if stream is not None:
                    val_batches, val_names = make_val_set_stream(
                        stream, seed, n_val_items, batch_items,
                        stage_host=stage_host)
                    logger.info("val set spans datasets: "
                                f"{sorted(set(val_names))}")
                else:
                    val_batches = make_val_set(
                        bank, scfg, tasks, input_modes, knobs, seed,
                        n_val_items, batch_items, stage_host=stage_host,
                        device=dev)
                val_batches = [apply_condition(b, cfg.get("condition"))
                               for b in val_batches]
                eval_step = make_eval_step(model, cfg, weight_dict, loss_fn,
                                           sample_accum=sample_accum)
            acc: dict = {}
            for vb in val_batches:
                vl = eval_step(state.model, _to(vb, dev))
                for k, v in vl.items():
                    acc[k] = acc.get(k, 0.0) + float(v) / len(val_batches)
            stats.update({f"val_{k}": v for k, v in acc.items()})
            logger.info(f"epoch {epoch} val loss {acc['loss_total']:.4f}")
            if (best_val_stats is None
                    or acc["loss_total"] < best_val_stats["loss_total"]):
                best_val_stats = acc
                save_best_checkpoint(
                    os.path.join(out_dir, "ckp"),
                    (epoch + 1) * itr_per_epoch, state,
                    extra={"epoch": epoch, "best_val_stats": best_val_stats})
                logger.info(f"epoch {epoch} new best "
                            f"({acc['loss_total']:.4f}) -> ckp/ckpt_best")

        write_log_line(os.path.join(out_dir, "log.txt"), stats)
        save_checkpoint(os.path.join(out_dir, "ckp"),
                        (epoch + 1) * itr_per_epoch, state,
                        extra={"epoch": epoch,
                               "best_val_stats": best_val_stats},
                        keep=keep_ckpt, block=False)
    finalize_pending()
    if stats:
        plot_loss(os.path.join(out_dir, "log.txt"),
                  keys=[k for k in stats if k.startswith("train_loss")])
    return state
