"""Probe whether gloo takes FSDP2's collectives on CUDA tensors, with two
ranks sharing one GPU (NCCL refuses two ranks on one device):

    python -m brainfm_tpu_torch.scripts.probe_fsdp_gloo

For each variant (a 2-layer Linear, and the joint model cut to f_maps 8,
3 levels, 32^3, sharded by parallel/fsdp.py::shard_state; each at fp32
and fp64) two processes of this module join a gloo group on cuda:0, take
two AdamW steps under FSDP2 and gather every parameter whole
(`DTensor.full_tensor`). Prints one JSON line per variant with each
rank's exit code and the tail of a failing rank's output. Exits 2
without CUDA.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import torch

VARIANTS = ("linear32", "linear64", "model32", "model64")


def _rank(variant: str, rank: int, port: str):
    import faulthandler

    from ..models import build_model
    from ..models.criterion import make_criterion
    from ..parallel import init_distributed, make_mesh
    from ..parallel.fsdp import full_tensor, shard_state
    from ..train.step import TrainState, build_optimizer, make_train_step
    from .train import train_config

    faulthandler.enable()
    init_distributed(f"localhost:{port}", 2, rank, backend="gloo")
    dev = torch.device("cuda", torch.cuda.current_device())
    dtype = torch.float64 if variant.endswith("64") else torch.float32
    mesh = make_mesh(2, 1, device_type="cuda")
    torch.manual_seed(0)
    if variant.startswith("linear"):
        model = torch.nn.Sequential(torch.nn.Linear(8, 8),
                                    torch.nn.Linear(8, 2)).to(dev, dtype)
        from torch.distributed.fsdp import fully_shard

        for m in model:
            fully_shard(m, mesh=mesh["data"])
        fully_shard(model, mesh=mesh["data"])
        opt = torch.optim.AdamW(model.parameters(), 1e-3)
        for _ in range(2):
            model(torch.randn(4, 8, device=dev, dtype=dtype)).sum() \
                .backward()
            opt.step()
            opt.zero_grad()
    else:
        cfg = train_config("brain_id", "joint")
        cfg.f_maps, cfg.num_levels, cfg.task_f_maps = 8, 3, [8]
        cfg.generator.size = [32, 32, 32]
        cfg.amp, cfg.remat, cfg.optimizer = False, False, "adamw"
        cfg, model = build_model(cfg, device=dev)
        model.to(dtype)
        shard_state(model, mesh)
        _, w, fn = make_criterion(cfg)
        g = torch.Generator(dev).manual_seed(rank)
        size = (1, 1, 32, 32, 32)
        lab = torch.randint(0, cfg.n_labels, size, generator=g, device=dev)
        batch = {"samples": {
            "input": torch.rand(*size, 1, generator=g, device=dev,
                                dtype=dtype),
            "bias_field_log": torch.zeros(*size, 1, device=dev, dtype=dtype)},
            "targets": {
            "T1": torch.rand(*size, 1, generator=g, device=dev, dtype=dtype),
            "segmentation": torch.nn.functional.one_hot(
                lab, cfg.n_labels).to(dtype),
            "distance": torch.zeros(*size, 4, device=dev, dtype=dtype),
            "registration": torch.zeros(*size, 3, device=dev, dtype=dtype)}}
        opt = build_optimizer(cfg, model.parameters())
        step = make_train_step(model, cfg, w, fn, opt, amp=False, mesh=mesh)
        st = TrainState(model, opt, 0)
        for lr in (1e-3, 5e-4):
            st, _ = step(st, batch, lr, 0.01)
    for p in model.parameters():
        full_tensor(p.detach())
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"OK {variant} rank {rank}", flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("probe_fsdp_gloo: no CUDA device", file=sys.stderr)
        return 2
    if argv:
        _rank(argv[0], int(argv[1]), argv[2])
        return 0
    env = dict(os.environ)
    env.pop("LOCAL_RANK", None)
    for variant in VARIANTS:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = str(s.getsockname()[1])
        procs = [subprocess.Popen(
            [sys.executable, "-m", __spec__.name, variant, str(r), port],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True) for r in range(2)]
        res = {"variant": variant, "rc": [], "fault": None}
        for p in procs:
            try:
                out = p.communicate(timeout=300)[0]
            except subprocess.TimeoutExpired:
                p.kill()
                out = "timed out\n" + p.communicate()[0]
            res["rc"].append(p.returncode)
            if p.returncode != 0 and res["fault"] is None:
                res["fault"] = out[-1500:]
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
