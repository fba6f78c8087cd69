"""The flagship trained data-parallel over the cards of one host, as the
reference launches it: one process per card (`torch.multiprocessing`'s
spawn), a process group over NCCL at tcp://localhost, the model whole on
every card, one item a rank, the gradients summed over the world.

Rank 0 is the harness's own process, so the trace, the spans and the
window's clock stay there. Its `Program` spawns ranks 1 to n-1, joins the
process group (`parallel/mesh.py::init_distributed`: each rank takes the
card of its rank modulo the host's cards), builds `make_mesh(data=n)` and
the step of `train/step.py::make_train_step(mesh=)`, the path
`train/loop.py::train(mesh=)` runs. Every rank builds the model with the
seed's weights and synthesizes its own items of every step: rank r makes
item n g + r of step g from step g's bank subject with that item's own
generator, so the ranks make the items one process makes for an n-item
batch. Before each iteration rank 0 broadcasts go or stop from the card,
on a stream of its own so the broadcast does not wait for rank 0's last
update, which costs it no host sync; the other ranks read it, count the
step and take its subject from the seed's order, as rank 0 does.

The output check covers every rank's items: in set-up (the first
CHECK_STEPS steps) each rank's items are gathered to rank 0, whose `batch`
returns the world's batch, and `step` takes rank 0's own share of it
(`parallel/mesh.py::shard_batch` splits the world's batch over the
ranks). The plain reference is drivers/train.py's, run as one process
over the union of the ranks' items. `free` stops the ranks and leaves the
process group. Every rank logs its set-up's phases to standard error. A
rank that ends before its stop, a group that does not form within
RENDEZVOUS_S, or an error on rank 0 on the card ends every rank and the
run at once with exit code 1, after each process has written its threads'
stacks.

The traffic's `ranks` is the world and `batch_items` the global batch.
Each rank runs torch on its share of the host's cores.
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import os
import signal
import socket
import sys
import threading
import time
import traceback

import torch

from ..record import log
from . import train as tr

STOP, GO = 0, 1
RENDEZVOUS_S = 300
_JOIN_S = 120
_T0 = time.perf_counter()      # a rank's phases are logged from here


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _threads(world: int) -> int:
    return max(1, (os.cpu_count() or 1) // world)


def _backend(dev) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def _phase(rank, what):
    log(f"rank {rank}: {what} at {time.perf_counter() - _T0:.2f} s")


def _end_ranks(workers):
    """Have each live rank write its stacks (SIGABRT, faulthandler), then
    kill it."""
    live = [p for p in workers if p.is_alive()]
    for p in live:
        with contextlib.suppress(OSError):
            os.kill(p.pid, signal.SIGABRT)
    for p in live:
        p.join(2.0)
        if p.is_alive():
            p.kill()


class Program(tr.Program):
    """One rank's training object. Built in a process without a process
    group (rank 0, the harness's), it starts the other ranks first."""

    def __init__(self, cfg_tree, traffic, seed, device, subjects):
        import torch.distributed as dist
        from brainfm_tpu_torch.parallel.mesh import (init_distributed,
                                                     make_mesh)

        self.world = int(traffic["ranks"])
        self.workers, self._threads_before = [], None
        self._stopping, self._joined = threading.Event(), threading.Event()
        if not dist.is_initialized():
            self._threads_before = torch.get_num_threads()
            torch.set_num_threads(_threads(self.world))
            port = _free_port()
            ctx = torch.multiprocessing.get_context("spawn")
            for r in range(1, self.world):
                p = ctx.Process(target=_rank_main, daemon=True, args=(
                    r, self.world, port, cfg_tree, traffic, seed,
                    device.type))
                p.start()
                self.workers.append(p)
            _phase(0, f"ranks 1-{self.world - 1} started")
            threading.Thread(target=self._watch, daemon=True).start()
            init_distributed(f"localhost:{port}", self.world, 0,
                             backend=_backend(device))
        self._joined.set()
        self.rank = dist.get_rank()
        _phase(self.rank, "in the process group")
        self.mesh = make_mesh(data=self.world)
        _phase(self.rank, "mesh made")
        super().__init__(cfg_tree, traffic, seed, device, subjects)
        _phase(self.rank, "model, weights and step built")
        self._msg = torch.zeros(1, dtype=torch.int64, device=device)
        self._side = None
        if device.type == "cuda":
            self._side = torch.cuda.Stream(device)
            self._side.wait_stream(torch.cuda.current_stream(device))

    def _watch(self):
        """End the run when a rank ends before its stop or the group does
        not form in time (rank 0 would wait for it in a collective)."""
        t = time.perf_counter()
        while not self._stopping.wait(0.5):
            for r, p in enumerate(self.workers, 1):
                if p.exitcode is not None and not self._stopping.is_set():
                    self._fail(f"rank {r} ended (exit code {p.exitcode}) "
                               "before its stop")
            if not self._joined.is_set() and \
                    time.perf_counter() - t > RENDEZVOUS_S:
                self._fail(f"the process group did not form in "
                           f"{RENDEZVOUS_S} s")

    def _fail(self, why):
        log(f"FATAL: {why}")
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        _end_ranks(self.workers)
        os._exit(1)

    def make_step(self, model, cfg, wdict, loss_fn, opt):
        from brainfm_tpu_torch.train.step import make_train_step

        return make_train_step(
            model, cfg, wdict, loss_fn, opt,
            sample_accum=int(cfg.get("grad_accum_samples") or 1),
            mesh=self.mesh)

    def _say(self, flag):
        """Rank 0: broadcast go or stop, filled on the card."""
        import torch.distributed as dist

        with (torch.cuda.stream(self._side) if self._side is not None
              else contextlib.nullcontext()):
            self._msg.fill_(int(flag))
            dist.broadcast(self._msg, 0)

    def listen(self) -> int:
        """Another rank: rank 0's go or stop."""
        import torch.distributed as dist

        dist.broadcast(self._msg, 0)
        return int(self._msg.item())

    def batch(self, gstep, subject):
        from brainfm_tpu_torch.synth.sharded import sharded_synth_batch
        from brainfm_tpu_torch.train.loop import apply_condition

        if self.rank == 0:
            self._say(GO)
        b = sharded_synth_batch(
            self.mesh, tr.item_generators(self.seed, gstep, self.batch_items,
                                          self.dev),
            self.bank.to_device(subject, self.dev), self.scfg, self.tasks,
            "synth", self.knobs)
        b = apply_condition(b, self.cfg.get("condition"))
        if gstep >= tr.CHECK_STEPS:
            return b
        b = self._gather(b)
        if gstep == 0:
            _phase(self.rank, "first item made and gathered")
        return b

    def _gather(self, tree):
        """Every rank's items of `tree` (its tensors' leading axis) on
        rank 0 in rank order, the world's batch there; the other ranks
        keep their own."""
        import torch.distributed as dist

        if isinstance(tree, dict):
            done = {k: self._gather(tree[k]) for k in sorted(tree)}
            return {k: done[k] for k in tree}
        if not torch.is_tensor(tree):
            return tree
        t = tree.contiguous()
        parts = ([torch.empty_like(t) for _ in range(self.world)]
                 if self.rank == 0 else None)
        dist.gather(t, parts, dst=0)
        return torch.cat(parts) if self.rank == 0 else tree

    def step(self, gstep, batch):
        """The step on this rank's items: of the world's batch (set-up on
        rank 0), its share."""
        from brainfm_tpu_torch.parallel.mesh import shard_batch

        if batch["samples"]["input"].shape[0] == self.batch_items:
            batch = shard_batch(self.mesh, batch)
        metrics = super().step(gstep, batch)
        if gstep == 0:
            _phase(self.rank, "first step issued")
        return metrics

    def free(self):
        """Every rank leaves the process group together (a barrier after
        rank 0's stop, then each destroys its side), then rank 0 joins
        the other ranks."""
        import torch.distributed as dist

        if self.rank == 0:
            self._stopping.set()
            self._say(STOP)
        dist.barrier()
        del self.mesh
        dist.destroy_process_group()
        _phase(self.rank, "left the process group")
        if self._threads_before is not None:
            torch.set_num_threads(self._threads_before)
        super().free()
        for p in self.workers:
            p.join(_JOIN_S)
        late = [r for r, p in enumerate(self.workers, 1) if p.exitcode != 0]
        for p in self.workers:
            if p.is_alive():
                p.kill()
        if self.workers:
            _phase(0, f"ranks 1-{self.world - 1} ended")
        if late:
            raise RuntimeError(f"ranks {late} did not end cleanly")


def _orphaned(parent: int):
    """A rank whose rank 0 is gone ends."""
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(1)


def _rank_main(rank, world, port, cfg_tree, traffic, seed, device_type):
    """Rank `rank` (1 to world - 1) in its own process: join the group,
    make the subjects and the training object, follow rank 0 step by
    step, each step's subject from the seed's order."""
    from brainfm_tpu_torch.parallel.mesh import init_distributed

    faulthandler.enable()
    threading.Thread(target=_orphaned, args=(os.getppid(),),
                     daemon=True).start()
    torch.set_num_threads(_threads(world))
    _phase(rank, "started")
    init_distributed(f"localhost:{port}", world, rank,
                     backend=_backend(torch.device(device_type)))
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device(device_type))
    subjects = tr.make_subjects(traffic, seed, dev)
    prog = Program(cfg_tree, traffic, seed, dev, subjects)
    order, g = [], 0
    while prog.listen() == GO:
        if g >= len(order):
            order = tr.subject_order(seed, len(subjects), 2 * g + 64)
        prog.step(g, prog.batch(g, order[g]))
        g += 1
    prog.free()


PROGRAM = Program
REFERENCE = tr.REFERENCE


def run(cell, seed, seconds, trace, device, clock):
    import multiprocessing

    try:
        out = tr.run(cell, seed, seconds, trace, device, clock, PROGRAM,
                     REFERENCE)
    except BaseException:
        # the other ranks would wait for rank 0 in a collective, and rank
        # 0's NCCL group in its exit
        _end_ranks(multiprocessing.active_children())
        if torch.device(device).type != "cuda":
            raise
        log("FATAL: rank 0 failed:\n" + traceback.format_exc())
        os._exit(1)
    return dataclasses.replace(out, devices=int(cell.traffic["ranks"]))
