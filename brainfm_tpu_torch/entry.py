"""The driver contract of the port: a single-card forward and a multi-rank
dry run (the twin of the repo's `__graft_entry__.py`).

    python -m brainfm_tpu_torch.entry                      # entry() on CUDA
    python -m brainfm_tpu_torch.entry --dryrun 1           # one NCCL rank
    python -m brainfm_tpu_torch.entry --dryrun 4 --device cpu  # gloo ranks

`entry()` returns the flagship joint model's forward and its example
arguments, every parameter zero. `dryrun_multichip(n)` runs a data x space
mesh over n ranks at 16^3 (f_maps 8, 3 levels): a data-parallel AdamW
step, the same step under FSDP2, a 3-tap conv tower through the halo
exchange, the space-sharded step and per-rank synthesis (K1 and K2 on
every rank) feeding the sharded step.

The top level imports nothing but the standard library: no torch, no
device. The ranks are processes of their own (`python -m
brainfm_tpu_torch.entry --rank R ...`), gloo on the CPU, NCCL on CUDA
with one card per rank.
"""

from __future__ import annotations

import argparse
import copy
import os
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the flagship joint model (cfgs/trainer/train/joint.yaml: f_maps 64,
# num_levels 6; the 160^3 crop of cfgs/generator/train/brain_id.yaml)
_JOINT_CFG = {
    "task": {"T1": True, "T2": True, "FLAIR": True, "CT": True,
             "segmentation": True, "distance": True, "registration": True,
             "bias_field": True},
    "generator": {"left_hemis_only": False, "size": [160, 160, 160]},
    "losses": {"uncertainty": None, "image_grad": True,
               "registration_grad": True, "bias_field_log_type": "l2"},
    "backbone": "unet3d", "f_maps": 64, "num_levels": 6, "num_groups": 8,
    "layer_order": "gcl", "unit_feat": False, "task_f_maps": [64],
}

DRYRUN_SIZE = (16, 16, 16)
# the dry run's small model and its train settings, over _JOINT_CFG
_SMALL = {"f_maps": 8, "num_levels": 3, "task_f_maps": [8],
          "label_list_segmentation_with_csf": [0, 14, 15, 16, 24, 77, 85],
          "relative_weight_lesions": 1.0, "optimizer": "adamw", "lr": 1e-4,
          "weight_decay": 0.0, "clip_max_norm": 0.0}
_DP_WEIGHTS = ("seg_ce", "seg_dice", "pathol_ce", "pathol_dice", "image",
               "image_grad", "bias_field_log", "distance", "registration",
               "registration_grad", "age", "contrastive")
_SYN_WEIGHTS = ("seg_ce", "seg_dice", "image", "image_grad",
                "bias_field_log", "distance", "registration",
                "registration_grad")
LR, WD = 1e-4, 0.0
TOWER_HALO = 8
FSDP_RTOL = 1e-5
TIMEOUT = 900


def _cfg(**over):
    from brainfm_tpu_torch.config import AttrDict

    d = copy.deepcopy(_JOINT_CFG)
    d.update(copy.deepcopy(over))
    return AttrDict.from_nested(d)


def entry(device=None, overrides=None, amp: bool = True):
    """The flagship forward and its arguments: `(fn, (params, x))`.

    The model is `_JOINT_CFG`'s (top-level keys replaced by `overrides`)
    built by models/build.py::build_model on `device` (default CUDA).
    `params` is its state dict with every tensor zero, fp32; `x` is a
    zero volume (1, D, H, W, 1) fp32 at the config's crop, in the joiners'
    channels-last layout, which is the JAX package's. `fn(params, x)` is
    the model's forward through `torch.func.functional_call`, under bf16
    autocast unless `amp` is False, and returns (T1, segmentation), the
    raw head outputs, as the JAX `fn` returns `model.apply`'s."""
    import torch

    from brainfm_tpu_torch.device import resolve_device
    from brainfm_tpu_torch.models import build_model

    dev = resolve_device(device)
    cfg, model = build_model(_cfg(**(overrides or {})), device=dev)
    model.eval()
    params = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    x = torch.zeros((1, *cfg.generator.size, 1), dtype=torch.float32,
                    device=dev)

    def fn(params, x):
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=amp):
            out = torch.func.functional_call(model, params, (x,))
        return out["T1"], out["segmentation"]

    return fn, (params, x)


# ------------------------------------------------------------ the dry run


def mesh_shape(n_devices: int) -> tuple[int, int]:
    """(data, space) of an n-rank dry run: space 2 when n is even and
    above 1."""
    space = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    return n_devices // space, space


def dryrun_cfg():
    """The config of the dry run's data-parallel, FSDP and space checks."""
    return _cfg(generator={"left_hemis_only": False,
                           "size": list(DRYRUN_SIZE)},
                weights={k: 1.0 for k in _DP_WEIGHTS}, **_SMALL)


def synth_cfg():
    """The config of the dry run's synthesis check."""
    return _cfg(task={"T1": True, "segmentation": True, "distance": True,
                      "registration": True, "bias_field": True},
                generator={"left_hemis_only": False,
                           "size": list(DRYRUN_SIZE), "max_rotation": 10,
                           "max_shear": 0.1, "max_scaling": 0.1,
                           "nonlinear_transform": True, "all_samples": 2,
                           "mild_samples": 1},
                weights={k: 1.0 for k in _SYN_WEIGHTS}, **_SMALL)


def numpy_draws(data: int, space: int, n_labels: int):
    """The dry run's numpy batch (B=data, S=2) and, when space > 1, the
    conv tower's input (1, 32, 16, 16, 1): one default_rng(0) in the JAX
    dry run's order, so both equal its arrays (fp64 here; it casts to
    fp32)."""
    import numpy as np

    size, B, S = DRYRUN_SIZE, data, 2
    rng = np.random.default_rng(0)
    batch = {"samples": {"input": rng.random((B, S, *size, 1)),
                         "bias_field_log": rng.random((B, S, *size, 1))}}
    t1 = rng.random((B, 1, *size, 1))
    seg = rng.integers(0, n_labels, (B, 1, *size))
    batch["targets"] = {"T1": t1,
                        "segmentation": np.eye(n_labels)[seg],
                        "distance": rng.random((B, 1, *size, 4)),
                        "registration": rng.random((B, 1, *size, 3))}
    xs = rng.random((1, 32, 16, 16, 1)) if space > 1 else None
    return batch, xs


def conv_tower(x):
    """Three stacked 3-tap convolutions along D (axis 2 of NCDHW), each
    with one zero voxel of padding at both ends: the dry run's tower."""
    import torch.nn.functional as F

    y = x
    for _ in range(3):
        yp = F.pad(y, (0, 0, 0, 0, 1, 1))
        y = yp[:, :, :-2] + 2.0 * yp[:, :, 1:-1] + yp[:, :, 2:]
    return {"y": y}


def _to_torch(tree, dev):
    import numpy as np
    import torch

    if isinstance(tree, dict):
        return {k: _to_torch(v, dev) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree, np.float32)).to(dev)


def _rows(batch, lo, hi):
    return {k: {kk: v[lo:hi] for kk, v in vv.items()}
            for k, vv in batch.items()}


def _step_loss(model, cfg, batch, mesh):
    """One AdamW step of `model` on this rank's `batch` under `mesh`;
    returns its loss_total."""
    from brainfm_tpu_torch.models.criterion import make_criterion
    from brainfm_tpu_torch.train.step import (TrainState, build_optimizer,
                                              make_train_step)

    _, weights, loss_fn = make_criterion(cfg)
    opt = build_optimizer(cfg, model.parameters())
    step = make_train_step(model, cfg, weights, loss_fn, opt, amp=False,
                           mesh=mesh)
    _, metrics = step(TrainState(model, opt, 0), batch, LR, WD)
    return float(metrics["loss_total"])


def _finite(name, v):
    import math

    if not math.isfinite(v):
        raise AssertionError(f"dryrun {name} loss {v} is not finite")


def run_rank(rank: int, world: int, dev, weights=None) -> dict:
    """The dry run's checks on one rank of a process group that is up.
    `weights`: a state dict file for the checks' model (default: torch's
    init from seed 0). Returns the losses, the tower's whole output (rank
    0, space > 1) and the kernels' launches over the rank's checks (K3-K5
    in its steps' GroupNorms, K1 and K2 in its synthesis)."""
    import numpy as np
    import torch

    from brainfm_tpu_torch import kernels
    from brainfm_tpu_torch.device import exact_fp32
    from brainfm_tpu_torch.models import build_model, process_args
    from brainfm_tpu_torch.parallel import (make_mesh, shard_state,
                                            spatial_shard_conv_apply)
    from brainfm_tpu_torch.parallel.mesh import axis_index, local_slice
    from brainfm_tpu_torch.parallel.spatial import gather_space, space_scope
    from brainfm_tpu_torch.synth import (SubjectBank, SynthStatic,
                                         build_knobs_stack)
    from brainfm_tpu_torch.synth.datasets import item_generator
    from brainfm_tpu_torch.synth.sharded import sharded_synth_batch

    data, space = mesh_shape(world)
    mesh = make_mesh(data, space)
    # the data-parallel view: rank r holds item r // space, so the world's
    # mean is the mean over the `data` items, as the JAX step's P("data")
    # batch replicated over 'space'
    dp_mesh = make_mesh(world, 1)
    out = {"mesh": {"data": data, "space": space}}
    kernels.reset_launches()

    def model_from_init():
        torch.manual_seed(0)
        _, m = build_model(cfg, device=dev)
        m.load_state_dict(init)
        return m

    with exact_fp32():
        torch.manual_seed(0)   # one init on every rank
        cfg, model = build_model(dryrun_cfg(), device=dev)
        init = (torch.load(weights, map_location=dev, weights_only=True)
                if weights else model.state_dict())
        init = {k: v.detach().clone() for k, v in init.items()}
        np_batch, xs = numpy_draws(data, space, cfg.n_labels)
        batch = _to_torch(np_batch, dev)
        item = rank // space
        mine = _rows(batch, item, item + 1)

        # 1. data-parallel step
        out["loss_total"] = _step_loss(model_from_init(), cfg, mine, dp_mesh)
        _finite("data-parallel", out["loss_total"])
        # 2. the same step, the state sharded with FSDP2
        out["fsdp_loss_total"] = _step_loss(
            shard_state(model_from_init(), dp_mesh), cfg, mine, dp_mesh)
        np.testing.assert_allclose(out["fsdp_loss_total"], out["loss_total"],
                                   rtol=FSDP_RTOL)
        if space > 1:
            # 3. the conv tower through the halo exchange: exact away from
            # the volume's ends
            x = _to_torch(xs, dev).movedim(-1, 1)    # (1, 1, 32, 16, 16)
            si = axis_index(mesh, "space")
            slab = spatial_shard_conv_apply(conv_tower,
                                            local_slice(x, space, si, 2),
                                            mesh, halo=TOWER_HALO)
            with space_scope(mesh) as sc:
                y = gather_space(slab["y"], 2, sc)
            want = conv_tower(x)["y"]
            np.testing.assert_allclose(y[:, :, 3:-3].cpu().numpy(),
                                       want[:, :, 3:-3].cpu().numpy(),
                                       rtol=1e-5)
            if rank == 0:
                out["tower"] = y.movedim(1, -1).cpu()
            # 4. the space-sharded step: this data rank's item, whole; the
            # step takes its slab
            di = axis_index(mesh, "data")
            out["space_loss_total"] = _step_loss(
                model_from_init(), cfg, _rows(batch, di, di + 1), mesh)
            _finite("space-sharded", out["space_loss_total"])
        del model

        # 5. per-rank synthesis feeding the sharded step: this data rank's
        # items, K1 and K2 on every rank
        syn_cfg = process_args(synth_cfg())
        scfg = SynthStatic.from_cfg(syn_cfg)
        bank = SubjectBank(bank_shape=(24, 24, 24))
        bank.add_debug_subject(seed=0, extent=(20, 20, 20))
        knobs = build_knobs_stack(scfg, "synth")
        gens = [item_generator(2, 0, i, dev) for i in range(data)]
        syn_batch = sharded_synth_batch(mesh, gens, bank.to_device(0, dev),
                                        scfg, tuple(syn_cfg.tasks), "synth",
                                        knobs)
        torch.manual_seed(1)
        _, syn_model = build_model(syn_cfg, device=dev)
        out["synth_loss_total"] = _step_loss(syn_model, syn_cfg, syn_batch,
                                             mesh)
        _finite("synth-pipeline", out["synth_loss_total"])
    out["launches"] = dict(kernels.LAUNCHES)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, device: str, out: str,
               weights=None) -> int:
    import torch
    import torch.distributed as dist

    from brainfm_tpu_torch.parallel import init_distributed

    if device == "cpu":
        torch.set_num_threads(max(1, int(os.environ.get(
            "OMP_NUM_THREADS", (os.cpu_count() or 1) // world))))
    init_distributed(f"localhost:{port}", world, rank,
                     backend="gloo" if device == "cpu" else "nccl")
    dev = torch.device("cpu") if device == "cpu" else torch.device(
        "cuda", torch.cuda.current_device())
    try:
        res = run_rank(rank, world, dev, weights)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def _wait_ranks(procs, timeout: float) -> list:
    """Wait for every rank; at the first that fails, or at the deadline,
    stop waiting (the caller kills the rest: a rank waiting for a dead
    peer would wait out its collective's own timeout). Returns [(rank,
    why)] of the ranks that failed or were still running."""
    deadline = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        bad = [(r, f"exit {c}") for r, c in enumerate(codes)
               if c not in (None, 0)]
        if bad:
            return bad
        if all(c == 0 for c in codes):
            return []
        if time.monotonic() > deadline:
            return [(r, f"still running after {timeout} s")
                    for r, c in enumerate(codes) if c is None]
        time.sleep(0.2)


def dryrun_multichip(n_devices: int, device=None, weights=None,
                     timeout: float = TIMEOUT) -> dict:
    """Run the dry run's checks on n ranks, each a process of its own.

    `device="cpu"`: n gloo ranks on the CPU. Default: n NCCL ranks, one
    card each (needs n cards; with fewer it raises, and names
    `device="cpu"`). A rank that fails, or outlives `timeout` seconds,
    makes this raise with its output, the other ranks stopped. Prints the JAX dry run's
    `dryrun_multichip ok:` line and returns rank 0's results: the mesh,
    `loss_total` (data-parallel), `fsdp_loss_total`, `space_loss_total`
    and `tower` (space > 1), `synth_loss_total`, and `launches`, each
    rank's kernel launches over its checks (`launches_by_rank`)."""
    import torch

    n = int(n_devices)
    kind = "cpu" if device is not None and torch.device(device).type == "cpu" \
        else "cuda"
    if kind == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"dryrun_multichip({n}) runs one NCCL rank per card and "
                f"finds {have} card(s); pass device='cpu' for gloo ranks "
                "on the CPU")
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=ROOT)
        procs, logs = [], []
        for r in range(n):
            cmd = [sys.executable, "-m", "brainfm_tpu_torch.entry",
                   "--rank", str(r), "--world", str(n), "--port", str(port),
                   "--device", kind, "--out", tmp]
            if weights:
                cmd += ["--weights", os.path.abspath(weights)]
            logs.append(open(os.path.join(tmp, f"rank{r}.log"), "w+"))
            procs.append(subprocess.Popen(
                cmd, cwd=ROOT, env=dict(env, LOCAL_RANK=str(r)),
                stdout=logs[-1], stderr=subprocess.STDOUT))
        try:
            failed = _wait_ranks(procs, timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in logs:
                f.close()
        if failed:
            msgs = []
            for r, why in failed:
                with open(os.path.join(tmp, f"rank{r}.log")) as f:
                    msgs.append(f"rank {r} ({why}):\n{f.read()[-4000:]}")
            raise RuntimeError("dryrun_multichip failed:\n" + "\n".join(msgs))
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(n)]
    res = dict(ranks[0])
    res["launches_by_rank"] = [r["launches"] for r in ranks]
    print("dryrun_multichip ok:", res["mesh"],
          {"loss_total": res["loss_total"]}, "synth-pipeline loss",
          res["synth_loss_total"], flush=True)
    return res


def _main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: CUDA")
    ap.add_argument("--dryrun", type=int, default=None, metavar="N",
                    help="run dryrun_multichip(N) instead of entry()")
    for flag in ("--rank", "--world", "--port"):
        ap.add_argument(flag, type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--weights", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args.rank, args.world, args.port, args.device,
                          args.out, args.weights)
    if args.dryrun is not None:
        dryrun_multichip(args.dryrun, device=args.device)
        return 0
    import torch

    fn, (params, x) = entry(args.device)
    with torch.no_grad():
        t1, seg = fn(params, x)
    print("entry ok:", {"T1": tuple(t1.shape),
                        "segmentation": tuple(seg.shape)}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_main())
