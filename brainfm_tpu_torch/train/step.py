"""The training step (port of brainfm_tpu/train/step.py).

Forward over the intra-subject sample stack, output processors, the
frozen implicit-pathology critic when one is given, weighted multi-task
criterion, non-finite skip, gradient clipping and an optimizer with its
learning rate and weight decay set per step, as the reference's
`train_one_epoch` body does. The two-stage step is the same step over a
TwoStage model (models/build.py), both stages under one optimizer.

PyTorch runs eagerly, so the JAX package's jit, donation and `lax.scan`
have no counterpart: a step is one backward (or one per microbatch) and an
in-place `optimizer.step()`. Mixed precision is `torch.autocast(bfloat16)`
around the model only; parameters, gradients and optimizer state stay in
the parameters' dtype, the heads' outputs are lifted to fp32 before the
processors and the criterion (`process_outputs(for_loss=True)`; the
segmentation logits go on in their own dtype), and bf16 needs no gradient
scaler. (The JAX package's bf16 path computes the processors and the
losses in bf16.)

With a mesh (parallel/mesh.py) each rank holds its data rank's items.
With a 'space' axis the model runs on this rank's D slab in a
`space_scope`, its outputs are gathered whole and the criterion runs whole
on every rank. Every rank backpropagates its loss times 1/(data x space)
and one SUM of the gradients over the world (a flat all_reduce) is the
gradient of the global batch; a model sharded with FSDP2, whose
reduce-scatter averages over 'data', takes 1/space and an all_reduce over
'space'. The gradient is clipped afterwards, as the JAX package clips the
global gradient. The non-finite skip is one decision for every rank.

A step is the span `step` over `step.forward` (the losses), `step.backward`,
`step.check` (the non-finite check, up to its host sync) and
`step.update` (clip and optimizer), utils/profiling.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from ..models.build import implicit_pathol_outputs, process_outputs
from ..models.criterion import weighted_total
from ..parallel.fsdp import is_sharded
from ..parallel.mesh import axis_size
from ..parallel.spatial import gather_outputs, slab_of, space_scope
from ..utils.profiling import annotate, count


@dataclass
class TrainState:
    """The model and optimizer are updated in place; `step` counts the
    optimizer updates applied (a skipped step leaves it as it was)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def clip_per_parameter(grads, clip: float):
    """Per-parameter-tensor L2 clipping, in place: each tensor is clipped
    to `clip` on its own (the reference's clip_gradients), not the global
    norm."""
    for g in grads:
        n = torch.sqrt(torch.sum(torch.square(g)))
        g.mul_(torch.clamp(clip / (n + 1e-6), max=1.0))


def clip_by_global_norm(grads, max_norm: float):
    """optax.clip_by_global_norm, in place: every tensor scaled by
    max_norm / |g| when the global norm |g| reaches max_norm."""
    g_norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    for g in grads:
        g.copy_(torch.where(g_norm < max_norm, g, g / g_norm * max_norm))


class LARS(torch.optim.Optimizer):
    """optax.lars with its defaults, which PyTorch lacks: decayed weights
    added to the gradient (every tensor), the update scaled by the trust
    ratio trust_coefficient * |p| / (|u| + eps) (1 where either norm is
    0; every tensor), then by -lr, then a momentum trace over the scaled
    updates (trace = u + momentum * trace), which is added to p."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0,
                 momentum: float = 0.9, trust_coefficient: float = 0.001,
                 eps: float = 0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      momentum=momentum,
                                      trust_coefficient=trust_coefficient,
                                      eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("LARS takes no closure")
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                u = p.grad + group["weight_decay"] * p
                pn = torch.linalg.vector_norm(p)
                un = torch.linalg.vector_norm(u)
                ratio = group["trust_coefficient"] * pn / (un + group["eps"])
                ratio = torch.where((pn == 0) | (un == 0),
                                    torch.ones_like(ratio), ratio)
                u = -group["lr"] * (u * ratio)
                st = self.state[p]
                if "momentum_buffer" not in st:
                    st["momentum_buffer"] = torch.zeros_like(p)
                buf = st["momentum_buffer"]
                buf.copy_(u + group["momentum"] * buf)
                p.add_(buf)


# optimizers whose weight decay is a per-step hyperparameter of the
# reference's chain (adam and sgd take none)
_DECOUPLED_WD = (torch.optim.AdamW, LARS)


def build_optimizer(cfg, params):
    """The configured optimizer over `params`: adam, adamw, sgd (momentum
    0.9) or lars, at cfg.lr and cfg.weight_decay. The step sets both per
    iteration, as optax.inject_hyperparams does; clipping is the step's
    (cfg.clip_max_norm, cfg.clip_mode)."""
    name = (cfg.optimizer or "adamw").lower()
    lr = float(cfg.lr or 1e-4)
    wd = float(cfg.weight_decay or 0.0)
    params = list(params)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, weight_decay=wd)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.9)
    if name == "lars":
        return LARS(params, lr=lr, weight_decay=wd)
    raise ValueError(f"unknown optimizer {name}")


def _clip_fn(cfg):
    """The gradient clip of cfg (clip_max_norm > 0): 'per_param'
    (default) or 'global'; None when off."""
    clip = float(cfg.clip_max_norm or 0.0)
    mode = str(cfg.get("clip_mode") or "per_param")
    if mode not in ("per_param", "global"):
        raise ValueError(f"clip_mode {mode!r}: 'per_param' or 'global'")
    if clip <= 0:
        return None
    fn = clip_by_global_norm if mode == "global" else clip_per_parameter
    return lambda grads: fn(grads, clip)


def amp_enabled(cfg, amp=None) -> bool:
    """bf16 autocast around the model: `amp` when given, else cfg.amp
    (default on, as the JAX training script)."""
    if amp is not None:
        return bool(amp)
    return bool(cfg.get("amp", True))


def _each(v, fn):
    """fn on a tensor, or on each tensor of a feature list."""
    return [fn(f) for f in v] if isinstance(v, list) else fn(v)


def batch_losses(model, cfg, loss_fn, batch, amp: bool, critic=None,
                 critic_image_key: str = "T1", detach_stage0: bool = False,
                 mesh=None):
    """Per-item losses of a batch, averaged over its B items. The model
    sees all B x S samples as one batch: GroupNorm is per sample, so this
    equals a forward per item. `critic`: the frozen implicit-pathology
    critic (models/build.py::build_critic_from_cfg), run per item on the
    predicted and the target image of `critic_image_key`, in fp32 outside
    the autocast. `detach_stage0`: a TwoStage model's stage 0 gets no
    gradient."""
    samples, targets = batch["samples"], batch["targets"]
    cond = batch.get("cond")
    x = samples["input"]
    B, S = x.shape[:2]

    def fold(a):
        return a.reshape(B * S, *a.shape[2:])

    kw = {"detach_stage0": True} if detach_stage0 else {}
    xin, cin = fold(x), None if cond is None else fold(cond)
    with space_scope(mesh) as sc:
        if sc is not None:
            xin, cin = slab_of(xin, sc), slab_of(cin, sc)
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=amp):
            out = model(xin, cond=cin, **kw)
    if "contrastive" not in cfg.tasks:
        # only the contrastive loss reads the features; dropping them
        # frees the fp32 unit-normalized last level, which nothing saves
        out = {k: v for k, v in out.items() if not k.startswith("feat")}
    if sc is not None:
        out = gather_outputs(out, sc)
    out = process_outputs(model, out, cfg, for_loss=True)

    def item(a, b):
        return a.reshape(B, S, *a.shape[1:])[b]

    per = []
    for b in range(B):
        ob = {k: _each(v, lambda t: item(t, b)) for k, v in out.items()}
        tb = {k: v[b] for k, v in targets.items()}
        if critic is not None:
            ob = implicit_pathol_outputs(critic, ob, tb, critic_image_key)
        per.append(loss_fn(ob, tb, {k: v[b] for k, v in samples.items()}))
    return {k: torch.mean(torch.stack([p[k] for p in per])) for k in per[0]}


def split_samples(batch, i: int, k: int):
    """Microbatch i of k over the sample axis S of (B, S, ...) samples
    (and cond); targets are shared."""
    S = batch["samples"]["input"].shape[1]
    n = S // k
    mb = dict(batch)
    mb["samples"] = {kk: v[:, i * n:(i + 1) * n]
                     for kk, v in batch["samples"].items()}
    if batch.get("cond") is not None:
        mb["cond"] = batch["cond"][:, i * n:(i + 1) * n]
    return mb


def _local(t):
    """A DTensor's local shard; any other tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def _all_reduce_flat(tensors, group=None):
    """SUM of every tensor over `group` in place, one bucket per dtype."""
    import torch.distributed as dist
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = _flatten_dense_tensors(ts)
        dist.all_reduce(flat, group=group)
        for t, r in zip(ts, _unflatten_dense_tensors(flat, ts)):
            t.copy_(r)


def _reduce_over_mesh(grads, total, losses, mesh):
    """The world's SUM of the gradients (their shares, see the module
    docstring), and the global batch's losses: the mean over the ranks
    (equal on the ranks of one space group)."""
    import torch.distributed as dist

    if any(hasattr(g, "to_local") for g in grads):
        # FSDP2 reduce-scattered over 'data' in the backward
        if axis_size(mesh, "space") > 1:
            _all_reduce_flat([_local(g) for g in grads],
                             mesh.get_group("space"))
    else:
        _all_reduce_flat(grads)
    n = dist.get_world_size()
    names = sorted(losses)
    every = [None] * n
    dist.all_gather_object(every, names)
    if any(e != names for e in every):
        raise ValueError(f"the ranks' items give different losses {every}: "
                         "a batch's items must share their targets")
    vals = torch.stack([torch.as_tensor(total)]
                       + [torch.as_tensor(losses[k]) for k in names])
    dist.all_reduce(vals)
    vals = vals / n
    return vals[0], {k: vals[i + 1] for i, k in enumerate(names)}


def _finite_update(state: TrainState, total, losses, lr, wd, clip,
                   mesh=None):
    """Skip-on-non-finite update: with a non-finite total or gradient the
    params, every optimizer state tensor and state.step stay bitwise as
    they were, the losses report NaN and 'skipped' 1 (0 otherwise). The
    check is one host sync per step. With a mesh the gradients and
    losses are reduced first and the skip is decided for every rank at
    once (a MAX of the non-finite flag over the world)."""
    model, optimizer = state.model, state.optimizer
    with annotate("step.check"):
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:
            if p.grad is None:   # a parameter the losses did not reach
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if mesh is not None:
            total, losses = _reduce_over_mesh(grads, total, losses, mesh)
        total = torch.as_tensor(total)
        ok = torch.stack([torch.isfinite(total).all()]
                         + [torch.isfinite(_local(g)).all()
                            for g in grads]).all()
        if mesh is not None:
            import torch.distributed as dist

            bad = (~ok).to(total.dtype if total.is_floating_point()
                           else torch.float32).reshape(1)
            dist.all_reduce(bad, op=dist.ReduceOp.MAX)
            ok = bad[0] == 0
        count("host_syncs")
        finite = bool(ok)
    dev = total.device
    with annotate("step.update"):
        if finite:
            if clip is not None:
                clip(grads)
            for group in optimizer.param_groups:
                group["lr"] = float(lr)
                if isinstance(optimizer, _DECOUPLED_WD):
                    group["weight_decay"] = float(wd)
            optimizer.step()
            state.step += 1
            metrics = {k: v.detach() for k, v in losses.items()}
            metrics["loss_total"] = total.detach()
        else:
            count("host_syncs")
            nan = torch.tensor(float("nan"), device=dev)
            metrics = {k: nan for k in losses}
            metrics["loss_total"] = nan
        count("host_syncs")
        metrics["skipped"] = torch.tensor(0.0 if finite else 1.0, device=dev)
        optimizer.zero_grad(set_to_none=True)
    return state, metrics


def make_train_step(model, cfg, weight_dict, loss_fn: Callable, optimizer,
                    sample_accum: int = 1, amp: bool | None = None,
                    critic=None, critic_image_key: str = "T1",
                    train_stage0: bool = True, mesh=None):
    """Returns `step(state, batch, lr, wd) -> (state, metrics)`.

    batch: {'samples': {...(B, S, ...)...}, 'targets': {...(B, 1, ...)...},
    'cond': optional (B, S, ...)}. `sample_accum`: the S-sample stack in k
    sequential microbatches, gradients summed and divided by k: exact, as
    the criterion means per-sample losses and nothing in the model couples
    samples; peak activation memory drops to one microbatch's. `amp`: bf16
    autocast around the model (default cfg.amp). `critic`: the frozen
    implicit-pathology critic scoring `critic_image_key`, its losses
    reaching the model through the predicted image only.
    `train_stage0=False` (a TwoStage model): stage 0's output is detached,
    so its parameters get zero gradients; they stay in the optimizer and
    are stepped, as the JAX package's stop_gradient leaves them (AdamW's
    decoupled decay and Adam's moments still move them). `mesh`: this
    rank's share of a data-parallel (and space-sharded) step; the model
    may be sharded with FSDP (parallel/fsdp.py)."""
    del model, optimizer   # the state carries both
    amp = amp_enabled(cfg, amp)
    clip = _clip_fn(cfg)
    k = int(sample_accum)
    def scale(model):   # see the module docstring
        n = axis_size(mesh, "space")
        return 1.0 / n if is_sharded(model) else 1.0 / (
            axis_size(mesh, "data") * n)

    def losses_and_total(model, batch):
        with annotate("step.forward"):
            losses = batch_losses(model, cfg, loss_fn, batch, amp, critic,
                                  critic_image_key,
                                  detach_stage0=not train_stage0, mesh=mesh)
            return weighted_total(losses, weight_dict), losses

    def backward(t, model):
        with annotate("step.backward"):
            (t if mesh is None else t * scale(model)).backward()

    def step(state: TrainState, batch, lr, wd):
        with annotate("step"):
            return one_step(state, batch, lr, wd)

    def one_step(state: TrainState, batch, lr, wd):
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        if k == 1:
            total, losses = losses_and_total(model, batch)
            backward(total, model)
            total = total.detach()
            losses = {kk: v.detach() for kk, v in losses.items()}
        else:
            S = batch["samples"]["input"].shape[1]
            assert S % k == 0, (
                f"sample_accum={k} must divide the intra-subject stack S={S}")
            totals, parts = [], []
            for i in range(k):
                t, part = losses_and_total(model, split_samples(batch, i, k))
                backward(t, model)   # .grad sums the microbatches
                totals.append(t.detach())
                parts.append({kk: v.detach() for kk, v in part.items()})
                del t, part
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(k)
            total = torch.mean(torch.stack(totals))
            losses = {kk: torch.mean(torch.stack([p[kk] for p in parts]))
                      for kk in parts[0]}
        return _finite_update(state, total, losses, lr, wd, clip, mesh)

    return step


def make_twostage_train_step(model, cfg, weight_dict, loss_fn: Callable,
                             optimizer, train_stage0: bool = True,
                             sample_accum: int = 1, amp: bool | None = None,
                             mesh=None):
    """The two-stage step over a TwoStage `model`: stage 0 predicts the
    mask, stage 1 sees the masked input conditioned on it, both stages
    under one optimizer; stage 0's sigmoid is kept, not squashed again by
    the processors. make_train_step with `train_stage0`."""
    return make_train_step(model, cfg, weight_dict, loss_fn, optimizer,
                           sample_accum=sample_accum, amp=amp,
                           train_stage0=train_stage0, mesh=mesh)
