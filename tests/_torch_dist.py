"""Spawned CPU ranks for the port's multi-process tests.

`spawn(task, world, tmp)` starts `world` Python processes, each joining a
gloo process group at a free localhost port, runs the rank function
`task` of this module in each and returns what every rank saved (a dict
per rank, torch.save'd under `tmp`). The ranks import torch and the port
only, never JAX: a test computes its JAX reference in its own process,
while the ranks run. Every rank function takes (rank, world, tmp) and
returns a dict.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300

_BOOT = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/tests']; "
         "import _torch_dist; _torch_dist._main(sys.argv[2:])")


def free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def spawn(task: str, world: int, tmp, timeout: int = TIMEOUT):
    """Start the ranks (without waiting); returns a handle for `collect`."""
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = ""
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BOOT, ROOT, task, str(r), str(world), port,
         str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, text=True) for r in range(world)]
    return task, procs, str(tmp), time.monotonic() + timeout


def collect(handle):
    """Wait for the ranks; every rank must exit 0. Returns their dicts."""
    task, procs, tmp, deadline = handle
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline
                                               - time.monotonic()))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {task}:\n{out[-4000:]}"
    return [torch.load(os.path.join(tmp, f"{task}_{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


def run(task: str, world: int, tmp, timeout: int = TIMEOUT):
    return collect(spawn(task, world, tmp, timeout))


def _main(argv):
    task, rank, world, port, tmp = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(2)
    from brainfm_tpu_torch.parallel import init_distributed

    init_distributed(f"localhost:{port}", world, rank, backend="gloo")
    out = globals()[f"rank_{task}"](rank, world, tmp)
    torch.save(out, os.path.join(tmp, f"{task}_{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


# ----------------------------------------------------------- shared set-up

def joint_cfg(f_maps=8, num_levels=2, size=(8, 8, 8), gen="brain_id",
              train="joint"):
    """The port's twin of tests/_torch_train_util.joint_cfg (which imports
    JAX): cfgs/trainer/train/<train>.yaml with the <gen> generator, cut
    to `f_maps`, `num_levels` and a `size` crop, no autocast."""
    from brainfm_tpu_torch.config import load_config, merge_missing

    g = load_config([os.path.join(ROOT, "cfgs/generator/default.yaml"), gen],
                    cfg_dir=os.path.join(ROOT, "cfgs/generator/train"))
    tr = load_config([os.path.join(ROOT, "cfgs/trainer/default_train.yaml"),
                      train], cfg_dir=os.path.join(ROOT, "cfgs/trainer/train"))
    merge_missing(tr, g)
    tr.f_maps, tr.num_levels, tr.task_f_maps = f_maps, num_levels, [f_maps]
    tr.generator.size = list(size)
    tr.amp = False
    return tr


def np_batch(seed, n_labels, size, B=1, S=2):
    """A random train batch of numpy arrays (as _torch_train_util's)."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, n_labels, (B, 1, *size))
    return {"samples": {"input": rng.random((B, S, *size, 1)),
                        "bias_field_log": 0.1 * rng.standard_normal(
                            (B, S, *size, 1))},
            "targets": {"T1": rng.random((B, 1, *size, 1)),
                        "segmentation": np.eye(n_labels)[lab],
                        "distance": rng.uniform(-2.5, 2.5, (B, 1, *size, 4)),
                        "registration": rng.standard_normal(
                            (B, 1, *size, 3))}}


def torch_batch(batch):
    return {k: {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
            for k, v in batch.items()}


def rows(batch, lo, hi):
    return {k: {kk: vv[lo:hi] for kk, vv in v.items()}
            for k, v in batch.items()}


def loss_and_grads(model, cfg, batch, mesh=None, age=None):
    """(total, {param: grad}) of the train step's loss on `batch`: this
    rank's share under `mesh` (the step's scaling), the whole otherwise.
    `age`: age targets added to the batch."""
    from brainfm_tpu_torch.models.criterion import (make_criterion,
                                                    weighted_total)
    from brainfm_tpu_torch.parallel.mesh import axis_size
    from brainfm_tpu_torch.train.step import batch_losses

    _, w, fn = make_criterion(cfg)
    if age is not None:
        batch = dict(batch)
        batch["targets"] = dict(batch["targets"], age=age)
    model.zero_grad(set_to_none=True)
    total = weighted_total(batch_losses(model, cfg, fn, batch, amp=False,
                                        mesh=mesh), w)
    scale = 1.0 if mesh is None else 1.0 / (axis_size(mesh, "data")
                                            * axis_size(mesh, "space"))
    (total * scale).backward()
    return float(total), {k: p.grad.detach().clone()
                          for k, p in model.named_parameters()
                          if p.grad is not None}


def world_sum(grads):
    for g in grads.values():
        torch.distributed.all_reduce(g)
    return grads


# ------------------------------------------------------------------ tasks

def rank_parallel(rank, world, tmp):
    """halo_exchange forward and backward, gather_space / slice_space
    backward (also on NDHWC slabs), make_mesh's size error, a blur tower
    through spatial_shard_conv_apply and the slab GroupNorm on space=2."""
    import torch.nn.functional as F

    from brainfm_tpu_torch.parallel import (halo_exchange, make_mesh,
                                            spatial_shard_conv_apply)
    from brainfm_tpu_torch.parallel.mesh import local_slice
    from brainfm_tpu_torch.parallel.spatial import (gather_space,
                                                    slice_space, space_scope)

    out = {}
    try:
        make_mesh(3, 1)
    except ValueError as e:
        out["mesh_error"] = str(e)
    mesh = make_mesh(1, world)
    group = mesh.get_group("space")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 4 * world, 5, 4, dtype=torch.float64, generator=g)
    weights = [torch.randn(2, 3, 8, 5, 4, dtype=torch.float64, generator=g)
               for _ in range(world)]
    h = 2
    xl = local_slice(x, world, rank, 2).clone().requires_grad_()
    got = halo_exchange(xl, h, group)
    (got * weights[rank]).sum().backward()
    xw = x.clone().requires_grad_()
    padded = F.pad(xw, (0, 0, 0, 0, h, h))
    sum((padded[:, :, q * 4:q * 4 + 4 + 2 * h] * weights[q]).sum()
        for q in range(world)).backward()
    out["halo_fwd"] = float((got - padded[:, :, rank * 4:rank * 4 + 4 + 2 * h])
                            .abs().max())
    out["halo_bwd"] = float((xl.grad - local_slice(xw.grad, world, rank, 2))
                            .abs().max())

    # gather_space: every rank's loss reads the whole tensor, so a slab's
    # gradient is the sum over the ranks; slice_space zero-pads
    with space_scope(mesh):
        xl2 = local_slice(x, world, rank, 2).clone().requires_grad_()
        whole = gather_space(xl2)
        (whole * whole * weights[rank][:, :, :whole.shape[2]]).sum() \
            .backward()
        z = x.clone().requires_grad_()
        (slice_space(z) * weights[rank][:, :, :4]).sum().backward()
    want = sum(2 * x * weights[q][:, :, :x.shape[2]] for q in range(world))
    out["gather_fwd"] = float((whole - x).abs().max())
    out["gather_bwd"] = float((xl2.grad - local_slice(want, world, rank, 2))
                              .abs().max())
    zwant = torch.zeros_like(x)
    local_slice(zwant, world, rank, 2).copy_(weights[rank][:, :, :4])
    out["slice_bwd"] = float((z.grad - zwant).abs().max())

    # shard_batch: rows over data, D slabs of 5+-dim volumes over space
    from brainfm_tpu_torch.parallel import shard_batch

    vol6 = torch.arange(2 * 8 * 4, dtype=torch.float64).reshape(2, 1, 8, 2,
                                                                2, 1)
    flat = torch.arange(2 * world)
    by_space = shard_batch(mesh, {"v": vol6, "f": flat})
    by_data = shard_batch(make_mesh(world, 1), {"v": vol6, "f": flat})
    m = 2 // world
    out["shard_batch"] = float(
        (by_space["v"] - local_slice(vol6, world, rank, 2)).abs().max()
        + (by_space["f"] - flat).abs().max()
        + (by_data["v"] - vol6[rank * m:(rank + 1) * m]).abs().max()
        + (by_data["f"] - flat[rank * 2:rank * 2 + 2]).abs().max())

    # replicate: rank 0's values everywhere, tensors and a module's
    from brainfm_tpu_torch.parallel import replicate

    mine = {"a": torch.full((3,), float(rank)), "b": [torch.tensor(rank)]}
    lin = torch.nn.Linear(2, 2)
    with torch.no_grad():
        lin.weight.fill_(rank + 1.0)
    rep = replicate(mesh, mine)
    replicate(mesh, lin)
    out["replicate"] = float(rep["a"].abs().sum() + rep["b"][0].abs()
                             + (lin.weight - 1.0).abs().sum())

    # a blur tower: two 3^3 convs, the JAX package's halo semantics
    gb = torch.Generator().manual_seed(1)
    vol = torch.randn(1, 2, 16, 12, 10, dtype=torch.float64, generator=gb)
    w1 = torch.randn(2, 2, 3, 3, 3, dtype=torch.float64, generator=gb) / 27
    w2 = torch.randn(2, 2, 3, 3, 3, dtype=torch.float64, generator=gb) / 27

    def tower(v):
        return F.conv3d(F.conv3d(v, w1, padding=1), w2, padding=1)

    out["blur_slab"] = spatial_shard_conv_apply(
        tower, local_slice(vol, world, rank, 2), mesh, halo=2).detach()
    out["blur_input"], out["blur_w"] = vol, (w1, w2)
    out.update(_slab_group_norm(rank, world, mesh))
    out.update(_exchanges_in_layout(rank, world, mesh))
    return out


def _exchanges_in_layout(rank, world, mesh):
    """halo_exchange, gather_space and slice_space on an NDHWC (channels-
    last) slab against the NCDHW slab of the same values, gradients
    included: {cl_<exchange>: (largest difference of the outputs and the
    gradients, whether the NDHWC output and gradient kept NDHWC)}."""
    from brainfm_tpu_torch.parallel import halo_exchange
    from brainfm_tpu_torch.parallel.mesh import local_slice
    from brainfm_tpu_torch.parallel.spatial import (gather_space,
                                                    slice_space, space_scope)

    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 3, 4 * world, 5, 4, dtype=torch.float64, generator=g)
    w = torch.randn(2, 3, 4 * world + 4, 5, 4, dtype=torch.float64,
                    generator=g)
    last = torch.channels_last_3d
    fns = {"halo": lambda t: halo_exchange(t, 2, mesh.get_group("space")),
           "gather": gather_space, "slice": slice_space}
    out = {}
    with space_scope(mesh):
        for what, fn in fns.items():
            src = x if what == "slice" else local_slice(x, world, rank, 2)
            res = []
            for fmt in (torch.contiguous_format, last):
                leaf = src.clone(memory_format=fmt).requires_grad_()
                y = fn(leaf)
                wy = w[tuple(slice(0, n) for n in y.shape)]
                # the gradient as the exchange's backward gives it (a
                # leaf's .grad would take the leaf's strides)
                gx, = torch.autograd.grad(
                    (y * wy.contiguous(memory_format=fmt)).sum(), leaf)
                res.append((y.detach(), gx))
            (y0, g0), (y1, g1) = res
            err = max(float((y0 - y1).abs().max()),
                      float((g0 - g1).abs().max()))
            kept = all(t.is_contiguous(memory_format=last) for t in (y1, g1))
            out[f"cl_{what}"] = (err, kept)
    return out


def gn_case():
    """The sharded GroupNorm's input (2, 16, 8, 6, 10), scale, bias and
    output cotangent, seeded numpy at fp64; 8 groups."""
    rng = np.random.default_rng(16)
    x = rng.standard_normal((2, 16, 8, 6, 10)) * 2.0 + 0.5
    return (x, rng.standard_normal(16), rng.standard_normal(16),
            rng.standard_normal(x.shape))


def _slab_group_norm(rank, world, mesh):
    """fused_group_norm on this rank's D slab of gn_case() over the
    space group: at fp64 the slab's output, dx and its share of the
    scale's and bias's gradients; in bf16 the slab's output, through the
    function and through a SingleConv's GroupNorm in a space scope (an
    identity 1^3 conv first, under autocast), beside the unsharded
    function's output of the whole tensor, sliced."""
    from brainfm_tpu_torch.models.unet3d import SingleConv
    from brainfm_tpu_torch.ops.groupnorm import fused_group_norm
    from brainfm_tpu_torch.parallel.mesh import local_slice
    from brainfm_tpu_torch.parallel.spatial import space_scope

    group = mesh.get_group("space")
    x, scale, bias, gy = (torch.from_numpy(a) for a in gn_case())

    def slab(t):
        return local_slice(t, world, rank, 2).contiguous()

    xs = slab(x).requires_grad_()
    sc, bi = scale.clone().requires_grad_(), bias.clone().requires_grad_()
    y = fused_group_norm(xs, sc, bi, 8, group=group)
    y.backward(slab(gy))
    out = {"gn_y": y.detach(), "gn_dx": xs.grad, "gn_dscale": sc.grad,
           "gn_dbias": bi.grad}

    xb, sb, bb = x.to(torch.bfloat16), scale.float(), bias.float()
    out["gn_bf16_want"] = slab(fused_group_norm(xb, sb, bb, 8))
    out["gn_bf16_fn"] = fused_group_norm(slab(xb), sb, bb, 8, group=group)
    layer = SingleConv(16, 16, order="cg", kernel_size=1)
    with torch.no_grad():
        layer.conv.weight.copy_(torch.eye(16).reshape(16, 16, 1, 1, 1))
        layer.groupnorm.weight.copy_(sb)
        layer.groupnorm.bias.copy_(bb)
    with space_scope(mesh), torch.no_grad(), \
            torch.autocast("cpu", dtype=torch.bfloat16):
        out["gn_bf16_layer"] = layer(slab(xb))
    return out


def _unet_case(kind):
    """(cfg, batch, age) of the spatial tests: the joint config at L6
    f_maps 8 over 48^3 ('joint', B=1, S=2), the same over two items with
    one sample each ('joint_b2'), or joint_age.yaml with unit_feat on
    ('age')."""
    if kind == "age":
        cfg = joint_cfg(8, 6, (48, 48, 48), gen="brain_id_age",
                        train="joint_age")
        cfg.unit_feat = True
        B, S = 1, 2
    else:
        cfg = joint_cfg(8, 6, (48, 48, 48))
        B, S = (2, 1) if kind == "joint_b2" else (1, 2)
    from brainfm_tpu_torch.models import build_model

    cfg, _ = build_model(cfg, device="meta")
    batch = torch_batch(np_batch(3, cfg.n_labels, (48, 48, 48), B=B, S=S))
    age = (torch.tensor([40.0, 70.0][:B], dtype=torch.float64)
           if kind == "age" else None)
    return cfg, batch, age


def _spatial(rank, world, tmp, data, space, kinds):
    from brainfm_tpu_torch.models import build_model
    from brainfm_tpu_torch.parallel import make_mesh
    from brainfm_tpu_torch.parallel.mesh import axis_index

    mesh = make_mesh(data, space)
    out = {}
    for kind in kinds:
        cfg, batch, age = _unet_case(kind)
        torch.manual_seed(0)
        _, model = build_model(cfg, device="cpu")
        model = model.double()
        path = os.path.join(tmp, "jax_weights.pt")
        if kind == "joint" and os.path.isfile(path):
            model.load_state_dict(torch.load(path, weights_only=True))
        B = batch["samples"]["input"].shape[0]
        di = axis_index(mesh, "data")
        m = B // data
        loss, grads = loss_and_grads(model, cfg, rows(batch, di * m,
                                                      (di + 1) * m),
                                     mesh, None if age is None
                                     else age[di * m:(di + 1) * m])
        t = torch.tensor([loss], dtype=torch.float64)
        torch.distributed.all_reduce(t)
        out[kind] = {"loss": float(t) / world, "grads": world_sum(grads)}
        if rank == 0:
            out[kind]["ref"] = loss_and_grads(model, cfg, batch, None, age)
    return out


def rank_spatial(rank, world, tmp):
    return _spatial(rank, world, tmp, 1, 2, ("joint", "age"))


def rank_spatial_dxs(rank, world, tmp):
    return _spatial(rank, world, tmp, 2, 2, ("joint_b2",))


def _small_model(seed=0, size=(16, 16, 16), num_levels=2):
    from brainfm_tpu_torch.models import build_model

    torch.manual_seed(seed)
    cfg, model = build_model(joint_cfg(8, num_levels, size), device="cpu")
    return cfg, model.double()


def _full_state(model):
    from brainfm_tpu_torch.parallel.fsdp import full_tensor

    return {k: full_tensor(v.detach()).clone()
            for k, v in model.state_dict().items()}


def rank_fsdp(rank, world, tmp):
    """data=2: two AdamW steps (per-tensor clip on) under FSDP and
    replicated, against one process's steps on the whole batch; a NaN in
    one rank's items skips the step on every rank; init_sharded against
    the replicated init; an FSDP checkpoint, saved by rank 0 and loaded
    back into the shards."""
    from brainfm_tpu_torch.models import build_model
    from brainfm_tpu_torch.models.criterion import make_criterion
    from brainfm_tpu_torch.parallel import init_sharded, make_mesh
    from brainfm_tpu_torch.parallel.fsdp import shard_state
    from brainfm_tpu_torch.train import checkpoint as ckpt
    from brainfm_tpu_torch.train.step import (TrainState, build_optimizer,
                                              make_train_step)

    mesh = make_mesh(world, 1)
    cfg, _ = _small_model()
    cfg.optimizer, cfg.clip_max_norm = "adamw", 0.05
    _, w, fn = make_criterion(cfg)
    batch = torch_batch(np_batch(5, cfg.n_labels, (16, 16, 16), B=world))
    nan = torch_batch(np_batch(5, cfg.n_labels, (16, 16, 16), B=world))
    nan["samples"]["input"][world - 1, 0, 3, 4, 5, 0] = float("nan")
    m = 1
    mine = rows(batch, rank * m, (rank + 1) * m)
    mine_nan = rows(nan, rank * m, (rank + 1) * m)
    out = {}

    def run(model, mesh_, b, bn):
        opt = build_optimizer(cfg, model.parameters())
        st = TrainState(model, opt, 0)
        step = make_train_step(model, cfg, w, fn, opt, amp=False, mesh=mesh_)
        losses = []
        for i, lr in enumerate((1e-3, 5e-4)):
            st, met = step(st, b, lr, 0.01)
            losses.append(float(met["loss_total"]))
        st, met = step(st, bn, 1e-3, 0.01)
        return st, losses, float(met["skipped"])

    # the sample stack in 2 microbatches under the mesh
    for name, mesh_, b in (("accum", mesh, mine), ("accum_single", None,
                                                   batch)):
        if mesh_ is None and rank != 0:
            continue
        _, model = _small_model()
        opt = build_optimizer(cfg, model.parameters())
        st, met = make_train_step(model, cfg, w, fn, opt, amp=False,
                                  mesh=mesh_, sample_accum=2)(
            TrainState(model, opt, 0), b, 1e-3, 0.01)
        out[name] = {"loss": float(met["loss_total"]),
                     "params": _full_state(model)}

    for name, sharded in (("fsdp", True), ("replicated", False)):
        _, model = _small_model()
        if sharded:
            shard_state(model, mesh)
        st, losses, skipped = run(model, mesh, mine, mine_nan)
        out[name] = {"losses": losses, "skipped": skipped, "step": st.step,
                     "params": _full_state(model)}
        if sharded:
            d = os.path.join(tmp, "ckp")
            ckpt.save_checkpoint(d, 2, st, extra={"epoch": 0})
            ckpt.finalize_pending()
            torch.distributed.barrier()
            out["opt_full"] = {k: {kk: _full(vv) for kk, vv in v.items()}
                               for k, v in st.optimizer.state_dict()[
                                   "state"].items()}
            # resume: the checkpoint into a fresh sharded model
            _, fresh = _small_model(seed=9)
            shard_state(fresh, mesh)
            rst = TrainState(fresh, build_optimizer(cfg, fresh.parameters()))
            rst = ckpt.load_checkpoint(os.path.join(d, "ckpt_000002"), rst)
            out["resumed"] = _full_state(fresh)
            out["resumed_step"] = rst.step
            out["resumed_opt"] = {
                k: {kk: _full(vv) for kk, vv in v.items()}
                for k, v in rst.optimizer.state_dict()["state"].items()}
    if rank == 0:
        _, model = _small_model()
        st, losses, skipped = run(model, None, batch, nan)
        out["single"] = {"losses": losses, "skipped": skipped,
                         "step": st.step, "params": _full_state(model)}

    # fp32 under FSDP2 on gloo (a custom divide factor would take
    # PREMUL_SUM, which gloo lacks)
    _, model = build_model(cfg, device="cpu")
    shard_state(model, mesh)
    b32 = {k: {kk: vv.float() for kk, vv in v.items()} for k, v in
           mine.items()}
    opt = build_optimizer(cfg, model.parameters())
    st, met = make_train_step(model, cfg, w, fn, opt, amp=False, mesh=mesh)(
        TrainState(model, opt, 0), b32, 1e-3, 0.01)
    out["fp32_loss"], out["fp32_step"] = float(met["loss_total"]), st.step

    torch.manual_seed(0)
    plain = build_model(cfg, device="cpu")[1]
    torch.manual_seed(0)
    sharded = init_sharded(lambda: build_model(cfg, device="meta")[1], mesh)
    out["init_plain"] = _full_state(plain)
    out["init_sharded"] = _full_state(sharded)
    out["init_local_numel"] = sum(p.to_local().numel()
                                  for p in sharded.parameters())
    out["init_numel"] = sum(p.numel() for p in plain.parameters())
    return out


def rank_fsdp_orbax(rank, world, tmp):
    """data=2: the JAX package's orbax checkpoint at tmp/jax/ckpt_000001
    (written by the test) loaded by load_checkpoint into an FSDP-sharded
    model and its AdamW optimizer; the gathered params, optimizer state
    and step."""
    from brainfm_tpu_torch.parallel import make_mesh
    from brainfm_tpu_torch.parallel.fsdp import shard_state
    from brainfm_tpu_torch.train import checkpoint as ckpt
    from brainfm_tpu_torch.train.step import TrainState, build_optimizer

    cfg, model = _small_model(seed=9)
    cfg.optimizer = "adamw"
    shard_state(model, make_mesh(world, 1))
    st = ckpt.load_checkpoint(
        os.path.join(tmp, "jax", "ckpt_000001"),
        TrainState(model, build_optimizer(cfg, model.parameters()), 0))
    return {"params": _full_state(model), "step": st.step,
            "opt": {k: {kk: _full(vv) for kk, vv in v.items()}
                    for k, v in st.optimizer.state_dict()["state"].items()}}


def _full(v):
    from brainfm_tpu_torch.parallel.fsdp import full_tensor

    return full_tensor(v).clone() if torch.is_tensor(v) else v


def _synth_setup():
    """A small generator setup (16^3 from 24^3 subjects, S=2)."""
    from brainfm_tpu_torch.models import build_model
    from brainfm_tpu_torch.synth import (SubjectBank, SynthStatic,
                                         knobs_from_cfg)

    cfg = joint_cfg(8, 2, (16, 16, 16))
    cfg.generator.all_samples, cfg.generator.mild_samples = 2, 1
    cfg, _ = build_model(cfg, device="meta")
    scfg = SynthStatic.from_cfg(cfg)
    bank = SubjectBank((24, 24, 24))
    for s in range(3):
        bank.add_debug_subject(seed=s, extent=(20, 22, 20))
    return cfg, scfg, bank, knobs_from_cfg(cfg, scfg, "synth")


def _same(a, b):
    return all(k in b and a[k].dtype == b[k].dtype
               and torch.equal(a[k], b[k]) for k in a) and set(a) == set(b)


def _batch_same(a, b):
    return all(_same(a[p], b[p]) for p in ("targets", "samples"))


def rank_sharded_synth(rank, world, tmp):
    """data=2 per-rank synthesis against serial make_batch, bitwise: a
    shared subject, per-item subjects, SynthDataset.get_batch_sharded on
    a data root (a homogeneous and a mixed-modality group)."""
    import chip_smoke
    from brainfm_tpu_torch.parallel import make_mesh
    from brainfm_tpu_torch.synth import datasets
    from brainfm_tpu_torch.synth.datasets import item_generator
    from brainfm_tpu_torch.synth.sharded import sharded_synth_batch
    from brainfm_tpu_torch.train.loop import make_batch

    mesh = make_mesh(world, 1)
    cfg, scfg, bank, knobs = _synth_setup()
    tasks = tuple(cfg.tasks)
    B = 2 * world
    lo, hi = rank * 2, rank * 2 + 2

    def gens(epoch):
        return [item_generator(0, epoch, i, "cpu") for i in range(B)]

    out = {}
    subj = bank.to_device(0, "cpu")
    got = sharded_synth_batch(mesh, gens(0), subj, scfg, tasks, "synth",
                              knobs)
    want = make_batch(gens(0), subj, scfg, tasks, "synth", knobs)
    out["shared"] = _batch_same(got, rows(want, lo, hi))
    out["shared_keys"] = sorted(got["targets"])

    subjects = [bank.to_device(i % len(bank), "cpu") for i in range(B)]
    mine = [s if lo <= i < hi else None for i, s in enumerate(subjects)]
    got = sharded_synth_batch(mesh, gens(1), mine, scfg, tasks, "synth",
                              knobs, per_item_subject=True)
    items = [make_batch([g], s, scfg, tasks, "synth", knobs)
             for g, s in zip(gens(1), subjects)]
    out["per_item"] = all(_batch_same(rows(got, i, i + 1), items[lo + i])
                          for i in range(hi - lo))

    root = os.path.join(tmp, "root")
    if rank == 0:
        chip_smoke.write_subject_root(root, (20, 22, 21))
    torch.distributed.barrier()
    gcfg = cfg.__class__.from_nested({
        "data_root": os.path.join(root, "data"),
        "split_root": os.path.join(root, "splits"), "split": "train",
        "dataset_names": ["HCP"], "dataset_option": "brain_id",
        "modality_probs": {"HCP": {"T1": 0.3, "T2": 0.3}},
        "generator": dict(cfg.generator)})

    def make():   # the pathology task draws lesions from the pool
        return datasets.build_datasets(gcfg, tasks + ("pathology",),
                                       device="cpu",
                                       bank_shape=(24, 24, 24))["HCP"]

    sharded, serial = make(), make()
    out["groups"] = []
    for epoch in range(4):
        sharded.reseed(epoch)
        serial.reseed(epoch)
        idxs = [0, 1, 1, 0]
        got = sharded.get_batch_sharded(mesh, idxs, gens(epoch))
        subjects, mode = serial.get_group(idxs)
        if subjects is None:
            modes = mode
            subjects = [serial._prep_subject(serial.bank.to_device(i, "cpu"),
                                             m) for i, m in zip(idxs, modes)]
        else:
            modes = [mode] * B
        items = [make_batch([g], s, serial.static, serial.tasks, m,
                            serial._knobs_for(m))
                 for g, s, m in zip(gens(epoch), subjects, modes)]
        out["lesions"] = out.get("lesions", 0) + sum(
            "pathol_prob" in s for s in subjects)
        out["groups"].append((sorted(set(modes)), all(
            _batch_same(rows(got, i, i + 1), items[lo + i])
            for i in range(hi - lo))))
    return out


def _write_vols(tmp):
    from brainfm_tpu_torch.utils import nifti

    import chip_smoke

    rng = np.random.default_rng(12)
    paths = []
    for i, side in enumerate((24, 40, 24)):
        p = os.path.join(tmp, f"vol{i}.nii.gz")
        nifti.save_nifti(p, rng.random((side,) * 3, dtype=np.float32),
                         chip_smoke.serve_affine((side,) * 3, (1, 1, 1)))
        paths.append(p)
    return paths


def serve_cfg():
    from brainfm_tpu_torch.config import AttrDict

    return AttrDict.from_nested(dict(
        task={t: True for t in ("T1", "segmentation", "distance",
                                "bias_field", "registration")},
        generator={"left_hemis_only": False, "size": [32, 32, 32]},
        losses={"uncertainty": None}, backbone="unet3d", f_maps=8,
        num_levels=3, num_groups=8, layer_order="gcl", unit_feat=False,
        task_f_maps=[8], max_surf_distance=3.0))


SERVE_VOL = (40, 36, 28)


def serve_volume():
    return np.random.default_rng(4).random(SERVE_VOL)


def rank_mesh_train(rank, world, tmp):
    """train(mesh=) data=2 on a bank at fp64 (per-step losses recorded),
    Inferencer(mesh=) with space=2 and data=2, evaluate_batch's check and
    evaluate_path(batch_size=2) over 3 files."""
    from brainfm_tpu_torch.infer import Inferencer
    from brainfm_tpu_torch.parallel import make_mesh

    from brainfm_tpu_torch.config import AttrDict, update_out_dir

    out = {"steps": train_small(os.path.join(tmp, "run"),
                                make_mesh(world, 1))}
    if rank == 1:
        time.sleep(1.1)   # a later clock than rank 0's
    out["out_dir"] = update_out_dir(AttrDict(job_name="j",
                                             exp_name="e")).out_dir
    inf = Inferencer(serve_cfg(), compute_dtype=torch.float64, device="cpu",
                     mesh=make_mesh(1, world))
    res = inf.evaluate_image(serve_volume())
    out["image"] = {k: v for k, v in res.items() if not k.startswith("feat")}
    out["feat"] = inf.evaluate_image(serve_volume(), feature_only=True)
    inf.mesh = make_mesh(world, 1)
    try:
        inf.evaluate_batch(np.zeros((3, 8, 8, 8)))
    except ValueError as e:
        out["batch_error"] = str(e)
    paths = [os.path.join(tmp, f"vol{i}.nii.gz") for i in range(3)]
    import contextlib
    import io

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        inf.evaluate_path(paths, os.path.join(tmp, "mesh_out"),
                          win_size=(32, 32, 32), batch_size=2,
                          exclude_keys=("segmentation",))
    out["path_log"] = text.getvalue()
    return out


def train_small(out_dir, mesh=None):
    """train() on a 2-subject bank at fp64: 2 epochs x 2 iterations of 2
    items, no validation; returns every step's loss_total (the batch is
    made in fp32 by the generator and lifted to fp64 for the step)."""
    from brainfm_tpu_torch.models.criterion import make_criterion
    from brainfm_tpu_torch.synth import SubjectBank
    from brainfm_tpu_torch.train import loop

    cfg, model = _small_model()
    cfg.n_epochs = 2
    _, w, fn = make_criterion(cfg)
    bank = SubjectBank((24, 24, 24))
    bank.add_debug_subject(seed=0, extent=(20, 22, 20))
    bank.add_debug_subject(seed=1, extent=(22, 20, 21))
    steps = []
    make = loop.make_train_step

    def recording(*a, **k):
        step = make(*a, **k)

        def run(state, batch, lr, wd):
            b = {kk: ({n: (t.double() if t.is_floating_point() else t)
                       for n, t in v.items()} if isinstance(v, dict) else v)
                 for kk, v in batch.items()}
            state, met = step(state, b, lr, wd)
            steps.append(float(met["loss_total"]))
            return state, met
        return run

    loop.make_train_step = recording
    try:
        loop.train(cfg, model, w, fn, bank, out_dir, itr_per_epoch=2,
                   batch_items=2, val_itr=0, log_itr=1, mesh=mesh)
    finally:
        loop.make_train_step = make
    return steps


# ------------------------------------------- the data-parallel flagship step

DP_SEED = 2600000017
DP_LR, DP_WD = 1e-3, 1e-2


def dp_tree():
    """The benchmark's `joint` configuration tree (brainbench/configs/
    joint.json) cut to f_maps 8, 2 levels and a 16^3 crop, no autocast."""
    import json

    with open(os.path.join(ROOT, "brainbench", "configs", "joint.json")) as f:
        tree = json.load(f)["cfg"]
    tree["f_maps"], tree["num_levels"], tree["task_f_maps"] = 8, 2, [8]
    tree["generator"]["size"] = [16, 16, 16]
    tree["amp"] = False
    return tree


def dp_port(tree, device="cpu", dtype=torch.float64):
    """The port's model of `tree` in `dtype` on `device` with the
    benchmark's seeded weights: (cfg, model, weight dict, loss fn,
    AdamW)."""
    from brainbench import inputs
    from brainfm_tpu_torch.config import AttrDict
    from brainfm_tpu_torch.models import build_model
    from brainfm_tpu_torch.models.criterion import make_criterion
    from brainfm_tpu_torch.train.step import build_optimizer

    cfg, model = build_model(AttrDict.from_nested(tree), device=device)
    inputs.load_weights(model, inputs.seed_weights(
        inputs.weight_specs(model), DP_SEED, device))
    model.to(dtype)
    _, w, fn = make_criterion(cfg)
    return cfg, model, w, fn, build_optimizer(cfg, model.parameters())


def dp_batches(tree, steps=2, items=2):
    """Each step's union batch, as the benchmark's training cells make it:
    `items` items from their per-item generators over one seeded 20^3
    subject in a 24^3 bank, lifted to fp64."""
    from brainbench.drivers import train as tr
    from brainfm_tpu_torch.config import AttrDict
    from brainfm_tpu_torch.models import build_model
    from brainfm_tpu_torch.synth import (SubjectBank, SynthStatic,
                                         knobs_from_cfg)
    from brainfm_tpu_torch.train.loop import make_batch

    cfg, _ = build_model(AttrDict.from_nested(tree), device="meta")
    scfg = SynthStatic.from_cfg(cfg)
    bank = SubjectBank((24, 24, 24))
    bank.subjects.extend(tr.make_subjects(
        {"subjects": 1, "extent": [20, 20, 20], "bank_shape": [24, 24, 24]},
        DP_SEED, torch.device("cpu")))
    knobs = knobs_from_cfg(cfg, scfg, "synth")
    out = []
    for g in range(steps):
        b = make_batch(tr.item_generators(DP_SEED, g, items, "cpu"),
                       bank.to_device(0, "cpu"), scfg, tuple(cfg.tasks),
                       "synth", knobs)
        out.append({k: {n: (t.double() if t.is_floating_point() else t)
                        for n, t in b[k].items()}
                    for k in ("samples", "targets")})
    return out


def adam_grads(model, opt):
    """Each parameter's first gradient as AdamW holds it after one step."""
    beta1 = opt.param_groups[0]["betas"][0]
    return {n: opt.state[p]["exp_avg"] / (1.0 - beta1)
            for n, p in model.named_parameters()}


def rank_dp_step(rank, world, tmp):
    """make_train_step(mesh=) data=world at fp64 over 2 steps of the union
    batches, each rank on its own items: the losses, the first gradient,
    the parameters' change; per step, recorded, the names of the
    `step.reduce` spans and the spans under it in the order they start,
    the counters and the object collectives called; the loss-name check
    on ranks whose losses differ."""
    import torch.distributed as dist

    from brainfm_tpu_torch.parallel import make_mesh
    from brainfm_tpu_torch.parallel.mesh import shard_batch
    from brainfm_tpu_torch.train import step as st
    from brainfm_tpu_torch.utils import profiling

    mesh = make_mesh(world, 1)
    tree = dp_tree()
    cfg, model, w, fn, opt = dp_port(tree)
    w0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = st.make_train_step(model, cfg, w, fn, opt, mesh=mesh)
    state = st.TrainState(model, opt, 0)
    objects = []
    gather_object = dist.all_gather_object
    dist.all_gather_object = lambda *a, **k: (objects.append(1),
                                              gather_object(*a, **k))[1]
    out = {"losses": [], "counts": [], "reduce_spans": [], "objects": []}
    try:
        for g, batch in enumerate(dp_batches(tree, items=2 * world)):
            with profiling.recording():
                state, met = step(state, shard_batch(mesh, batch), DP_LR,
                                  DP_WD)
            out["losses"].append(float(met["loss_total"]))
            out["counts"].append(dict(profiling.COUNTS))
            out["reduce_spans"].append([
                s.name for s in sorted(profiling.SPANS, key=lambda s: s.t0)
                if s.name.startswith("step.reduce")])
            out["objects"].append(len(objects))
            if g == 0:
                out["grads"] = adam_grads(model, opt)
    finally:
        dist.all_gather_object = gather_object
    out["update"] = {n: p.detach() - w0[n]
                     for n, p in model.named_parameters()}
    out["grad_bytes"] = sum(p.numel() * p.element_size()
                            for p in model.parameters() if p.requires_grad)
    try:
        st._check_loss_names(["loss_a", "loss_b"][:rank + 1],
                             torch.device("cpu"))
    except ValueError as e:
        out["names_error"] = str(e)
    return out
