"""The training loop (port of brainfm_tpu/train/loop.py).

Per-iteration schedule lookup, per-step metrics with an epoch nanmean,
fixed-seed validation with best-checkpoint handling, the rolling epoch
checkpoint and the loss curve. Every item is synthesized on the model's
device by `synth_item`, so K1 (ops/warp.py) and K2 (ops/lut.py) run in
every iteration. Items come from a subject bank or from the
multi-dataset stream (synth/datasets.py::ConcatStream). Randomness is
drawn per epoch from (seed, epoch): one torch generator per item, from
(seed, epoch, item), and numpy generators for the host draws, all made
anew each epoch, so a run resumed at an epoch boundary draws what an
uninterrupted one draws, and a data rank of a mesh makes exactly the
items a single process makes in its rows of the batch. With
`losses.implicit_pathol` the frozen critic scores every step and
validation batch; `twostage_models` trains the two-stage pair. Every
`vis_itr` steps the visualizer writes PNG montages, feature strips and
NIfTI dumps of a forward on the step's batch.

`mesh=` (parallel/mesh.py) trains data-parallel, one process per rank:
each data rank synthesizes only its own items (synth/sharded.py), the
volume's D axis may be split over 'space', and `fsdp=True` shards the
parameters and the optimizer state over 'data' (parallel/fsdp.py). Logs,
the loss curve and checkpoints are written by rank 0; every rank scores
the same validation set.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models.build import build_critic_from_cfg, process_outputs
from ..models.criterion import weighted_total
from ..parallel.mesh import axis_size, process_index
from ..synth import SynthStatic, knobs_from_cfg, synth_item
from ..synth.batch import stack_items
from ..synth.datasets import item_generator
from ..synth.sharded import sharded_synth_batch
from ..synth.sampler import WeightedSubjectSampler, choose_modality
from ..utils.logging import plot_loss, setup_logging, write_log_line
from ..utils.nifti import viewVolume
from ..utils.visualizer import FeatVisualizer, TaskVisualizer, to_host
from .checkpoint import (finalize_pending, load_checkpoint, read_extra,
                         save_best_checkpoint, save_checkpoint)
from .schedules import build_schedules
from .step import (TrainState, _each, amp_enabled, batch_losses,
                   build_optimizer, make_train_step, make_twostage_train_step,
                   split_samples)


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
                   amp: bool | None = None, critic=None,
                   critic_image_key: str = "T1", mesh=None):
    """Validation step `step(model, batch) -> losses` (with 'loss_total'):
    forward + criterion under torch.no_grad, with the train step's frozen
    critic when one is given, so validation scores what training does.
    `sample_accum`: the S-sample stack in sequential chunks whose losses
    are averaged (exact, as the train step's; skipped when it does not
    divide S)."""
    del model   # the caller passes the model to each call
    amp = amp_enabled(cfg, amp)
    k = int(sample_accum)

    def losses_of(model, batch):
        return batch_losses(model, cfg, loss_fn, batch, amp, critic,
                            critic_image_key, mesh=mesh)

    @torch.no_grad()
    def step(model, batch):
        S = batch["samples"]["input"].shape[1]
        if k > 1 and S % k == 0 and S > 1:
            parts = [losses_of(model, split_samples(batch, i, k))
                     for i in range(k)]
            losses = {kk: torch.mean(torch.stack([p[kk] for p in parts]))
                      for kk in parts[0]}
        else:
            losses = losses_of(model, batch)
        losses["loss_total"] = torch.as_tensor(
            weighted_total(losses, weight_dict))
        return losses

    return step


def make_twostage_eval_step(model, cfg, weight_dict, loss_fn,
                            amp: bool | None = None, mesh=None):
    """Validation twin of make_twostage_train_step over a TwoStage
    `model`: the chained forward, stage 0's sigmoid kept, the criterion,
    no gradients; `step(model, batch) -> losses`."""
    return make_eval_step(model, cfg, weight_dict, loss_fn, amp=amp,
                          mesh=mesh)


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


def _bank_batch(bank, idx, dev, stage_host, input_prob, rng_host,
                input_modes, knobs, cfg, scfg, tasks, generators, mesh=None):
    """One train batch from bank subject `idx`: its modality drawn from
    `input_prob` (or `input_modes`), then one item per generator (with a
    mesh: this data rank's items only). A staged subject is freed before
    the caller's step."""
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
    if mesh is not None:
        return sharded_synth_batch(mesh, generators, subj, scfg, tasks, mode,
                                   knobs[mode])
    return make_batch(generators, subj, scfg, tasks, mode, knobs[mode])


@torch.no_grad()
def visualize_step(cfg, model, batch, gstep: int, out_dir: str,
                   write: bool = True):
    """The periodic visualization (parity: loop.py:547-600): a forward of
    the batch's first item (its S samples) under the step's autocast,
    the output processors (a two-stage model's 'feat_task' is its 'feat'
    and its 'pathology' is already a sigmoid), then the feature strips of
    the last decoder level (`visualizer.feat_vis`) under vis_feat/, the
    NIfTI dumps (`visualizer.make_results`) under vis/results_<step>/ and
    the montage under vis/. No parameter, gradient or random state is
    touched. `write=False` runs the forward only (a rank of a sharded
    model that writes nothing)."""
    vcfg = cfg.get("visualizer")
    x = batch["samples"]["input"][0]
    c = batch.get("cond")
    with torch.autocast(x.device.type, dtype=torch.bfloat16,
                        enabled=amp_enabled(cfg)):
        outs = model(x, cond=None if c is None else c[0])
    outs = {("feat" if k == "feat_task" else k): _each(v, lambda t: t.float())
            for k, v in outs.items() if k != "feat_pathol"}
    outs = process_outputs(model, outs, cfg)
    if not write:
        return
    if vcfg is not None and vcfg.get("feat_vis") and "feat" in outs:
        FeatVisualizer(os.path.join(out_dir, "vis_feat"),
                       n_channels=int(vcfg.get("feat_vis_num") or 10)
                       ).visualize(gstep, outs["feat"][-1])
    if vcfg is not None and vcfg.get("make_results"):
        rdir = os.path.join(out_dir, "vis", f"results_{gstep}")
        os.makedirs(rdir, exist_ok=True)
        viewVolume(to_host(batch["samples"]["input"][0, 0, ..., 0]),
                   names=["input"], save_dir=rdir)
        for k in ("T1", "label", "bias_field_log"):
            if k in outs:
                viewVolume(to_host(outs[k][0]).squeeze(), names=[f"pd_{k}"],
                           save_dir=rdir)
            if k in batch["targets"]:
                # [0, 0]: the first item's first slice, as the JAX loop
                viewVolume(to_host(batch["targets"][k][0, 0]).squeeze(),
                           names=[f"gt_{k}"], save_dir=rdir)
    TaskVisualizer(os.path.join(out_dir, "vis")).visualize(
        gstep, {k: v[0] for k, v in batch["samples"].items()},
        {k: v[0] for k, v in batch["targets"].items()},
        {k: v for k, v in outs.items() if k != "feat"})


def _check_mesh(mesh, fsdp: bool, batch_items: int):
    """The JAX loop's checks of mesh= and fsdp=."""
    from torch.distributed.device_mesh import DeviceMesh

    if fsdp and mesh is None:
        raise ValueError("fsdp=True requires a mesh with a 'data' axis — "
                         "without one the state would silently stay "
                         "single-device fully replicated")
    if mesh is None:
        return
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh (parallel.make_mesh), "
                        f"not {type(mesh).__name__}")
    if "data" not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh axes {mesh.mesh_dim_names} have no 'data'")
    if batch_items % axis_size(mesh, "data"):
        raise ValueError(f"batch_items {batch_items} is not a multiple of "
                         f"the mesh 'data' axis {axis_size(mesh, 'data')}")


def train(cfg, model, weight_dict, loss_fn, bank, out_dir: str,
          itr_per_epoch: int = 100, batch_items: int = 1,
          input_modes=("synth",), seed: int = 0, log_itr: int = 10,
          resume: str | None = None, vis_itr: int = 0, val_itr: int = 1,
          n_val_items: int = 2, keep_ckpt: int = 2, stream=None, mesh=None,
          fsdp: bool = False, twostage_models=None):
    """Run the training loop on the model's device. `bank`: SubjectBank;
    `cfg`: the processed trainer config (with .generator etc.).

    `twostage_models`: the two-stage pair (the TwoStage of
    models/build.py::build_inpaint_model), trained in place of `model`
    under one optimizer with
    cfg.train_stage0 (default true; false detaches stage 0, whose
    parameters still take AdamW's decay). cfg.condition and
    losses.implicit_pathol are refused with it, as in the JAX package.
    With losses.implicit_pathol the frozen critic
    (build_critic_from_cfg) scores every step and validation batch.

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
    TrainState.

    `mesh`: a DeviceMesh of parallel.make_mesh, one process per rank (the
    multi-GPU path of the JAX loop): batch_items must be a multiple of
    its 'data' axis; data rank r synthesizes items r*B/n ... of every
    batch (the stream path plans a whole batch from one dataset,
    ConcatStream.epoch_grouped, the same plan on every rank), a 'space'
    axis splits the forward's D axis, and the gradients are summed over
    the world (train/step.py). `fsdp`: with a mesh (required; raises
    without one) the parameters and the optimizer state are sharded over
    'data' (parallel/fsdp.py); a model that is not sharded yet (a resume
    builds it replicated) is sharded here, and the checkpoint loads into
    the shards."""
    _check_mesh(mesh, fsdp, batch_items)
    rank0 = process_index() == 0
    losses_cfg = cfg.losses if getattr(cfg, "losses", None) else {}
    if twostage_models is not None:
        if losses_cfg.get("implicit_pathol"):
            raise ValueError("losses.implicit_pathol is not supported with "
                             "two-stage training (the reference's twostage "
                             "engine has no PatholSeg critic either)")
        if cfg.get("condition"):
            raise ValueError("cfg.condition is not supported with two-stage "
                             "training: stage-1 is conditioned on stage-0's "
                             "predicted mask internally")
        model = twostage_models

    os.makedirs(out_dir, exist_ok=True)
    logger = setup_logging(os.path.join(out_dir, "train.log"))
    if fsdp:
        from ..parallel.fsdp import shard_state

        shard_state(model, mesh)
    dev = next(model.parameters()).device
    critic, critic_key = build_critic_from_cfg(cfg, device=dev)
    if critic is not None:
        critic.to(next(model.parameters()).dtype)
        logger.info(f"implicit-pathology critic on (scores '{critic_key}')")
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
    if twostage_models is not None:
        step_fn = make_twostage_train_step(
            model, cfg, weight_dict, loss_fn, optimizer,
            train_stage0=bool(cfg.get("train_stage0", True)),
            sample_accum=sample_accum, mesh=mesh)
    else:
        step_fn = make_train_step(model, cfg, weight_dict, loss_fn,
                                  optimizer, sample_accum=sample_accum,
                                  critic=critic,
                                  critic_image_key=critic_key, mesh=mesh)
    knobs = {m: knobs_from_cfg(cfg, scfg, m) for m in set(input_modes)}
    sampler = (WeightedSubjectSampler([len(bank)], seed=seed)
               if stream is None else None)
    if mesh is not None and stream is not None:
        # one batch plan for every rank: the data split is by item
        stream.sampler.process_index = 0
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
        rng_host = np.random.default_rng((seed, epoch))
        metric_hist: list = []
        t_ep = time.time()
        if stream is not None and mesh is not None:
            group_plan = list(stream.epoch_grouped(epoch, itr_per_epoch,
                                                   batch_items))
        elif stream is not None:
            item_iter = stream.epoch(epoch, itr_per_epoch * batch_items,
                                     seed)
        else:
            sampler.set_epoch(epoch)
            subj_plan = sampler.sample(itr_per_epoch)
        for it in range(itr_per_epoch):
            gstep = epoch * itr_per_epoch + it
            gens = [item_generator(seed, epoch, it * batch_items + i, dev)
                    for i in range(batch_items)]
            if stream is not None and mesh is not None:
                name, idxs = group_plan[it]
                batch = stream.datasets[name].get_batch_sharded(mesh, idxs,
                                                                gens)
            elif stream is not None:
                items = [next(item_iter) for _ in range(batch_items)]
                batch = _to(stack_items([t for _, t, _ in items],
                                        [s for _, _, s in items]), dev)
                del items
            else:
                batch = _bank_batch(bank, subj_plan[it][1], dev, stage_host,
                                    input_prob, rng_host, input_modes, knobs,
                                    cfg, scfg, tasks, gens, mesh)
            batch = apply_condition(batch, cfg.get("condition"))
            lr = float(lr_sched[min(gstep, len(lr_sched) - 1)])
            wd = float(wd_sched[min(gstep, len(wd_sched) - 1)])
            state, metrics = step_fn(state, batch, lr, wd)
            if vis_itr and gstep % vis_itr == 0 and (rank0 or fsdp):
                # a sharded model's forward needs every rank
                visualize_step(cfg, state.model, batch, gstep, out_dir,
                               write=rank0)
            del batch
            metric_hist.append(metrics)
            if it % log_itr == 0:
                logger.info(f"epoch {epoch} it {it}/{itr_per_epoch} "
                            f"lr {lr:.2e} "
                            f"loss {float(metrics['loss_total']):.6g} "
                            f"skipped {int(metrics['skipped'])}")
        # nanmean: skipped steps report NaN losses and must not poison the
        # epoch averages; 'skipped' is 0/1, so its mean is the skip share.
        # A loss whose target some datasets lack is averaged over the
        # steps that have it
        keys = dict.fromkeys(k for m in metric_hist for k in m)
        stats = {f"train_{k}": float(torch.nanmean(torch.stack(
            [m[k].float() for m in metric_hist if k in m]))) for k in keys}
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
                eval_step = (
                    make_twostage_eval_step(model, cfg, weight_dict, loss_fn,
                                            mesh=mesh)
                    if twostage_models is not None else
                    make_eval_step(model, cfg, weight_dict, loss_fn,
                                   sample_accum=sample_accum, critic=critic,
                                   critic_image_key=critic_key, mesh=mesh))
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

        if rank0:
            write_log_line(os.path.join(out_dir, "log.txt"), stats)
        save_checkpoint(os.path.join(out_dir, "ckp"),
                        (epoch + 1) * itr_per_epoch, state,
                        extra={"epoch": epoch,
                               "best_val_stats": best_val_stats},
                        keep=keep_ckpt, block=False)
    finalize_pending()
    if stats and rank0:
        plot_loss(os.path.join(out_dir, "log.txt"),
                  keys=[k for k in stats if k.startswith("train_loss")])
    return state
