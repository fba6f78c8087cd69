"""Process groups, the device mesh and the batch rules (port of
brainfm_tpu/parallel/mesh.py).

The JAX package has one controller and lets GSPMD insert the collectives.
PyTorch runs one process per rank and calls torch.distributed itself, so
here a "mesh" is a `torch.distributed.device_mesh.DeviceMesh` over every
process, with the JAX package's two named axes in its data-major order:

  data  - batch data parallelism: each data rank holds its own items and
          the gradients are summed over the world
  space - the volume's D axis split into slabs (parallel/spatial.py)

A launch is one process per rank (torchrun's RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT and LOCAL_RANK, or explicit arguments, one
card a rank).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def process_index() -> int:
    """This process's rank in the default process group, 0 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def process_count() -> int:
    """The default process group's size, 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def default_backend() -> str:
    """'nccl' when the ranks run on CUDA, 'gloo' on the CPU."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None):
    """Join the process group; returns (rank, world size).

    With `coordinator` ("host:port" or a URL), `num_processes` and
    `process_id`, init_process_group rendezvouses over TCP there. With no
    arguments it reads torchrun's RANK / WORLD_SIZE / MASTER_ADDR /
    MASTER_PORT; without those it does nothing and returns (0, 1), as the
    JAX function on a single host. `backend` defaults to 'nccl' when CUDA
    is available and 'gloo' otherwise; it never changes behind the
    caller's back. On CUDA the process takes device LOCAL_RANK when that
    is set (torchrun), else its rank modulo the host's device count (a
    launch of one process per card on a single host, as
    `torch.multiprocessing.spawn` starts them). A failed launch raises."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator:
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        rank = int(process_id)
        kw = dict(init_method=url, world_size=int(num_processes), rank=rank)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        kw = dict(init_method="env://")
    else:
        return 0, 1
    backend = backend or default_backend()
    if torch.cuda.is_available():
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend=backend, **kw)
    return dist.get_rank(), dist.get_world_size()


def make_mesh(data: int | None = None, space: int = 1,
              device_type: str | None = None):
    """A DeviceMesh of shape (data, space) named ("data", "space") over
    every process, data-major as `np.asarray(devices).reshape(data,
    space)`. `data` defaults to world // space. `device_type` defaults to
    'cuda' under NCCL and 'cpu' otherwise."""
    from torch.distributed.device_mesh import DeviceMesh

    n = process_count()
    if data is None:
        data = n // space
    if data * space != n:
        raise ValueError(f"mesh {data}x{space} != {n} devices")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_distributed() first")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = np.arange(n).reshape(data, space)
    return DeviceMesh(device_type, torch.from_numpy(ranks),
                      mesh_dim_names=("data", "space"))


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def data_sharding(mesh, leading_axis: bool = True):
    """The leading-axis rule as DTensor placements over the mesh: Shard(0)
    over 'data', replicated over 'space'."""
    from torch.distributed.tensor import Replicate, Shard

    del leading_axis
    return (Shard(0), Replicate())


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def replicate(mesh, tree):
    """Every tensor of `tree` (an nn.Module: its parameters and buffers,
    in place) broadcast from rank 0, so every rank holds rank 0's values."""
    del mesh
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                dist.broadcast(t.data, src=0)
        return tree

    def bcast(x):
        if torch.is_tensor(x):
            x = x.clone()
            dist.broadcast(x, src=0)
        return x

    return _map(bcast, tree)


def local_slice(x, n: int, i: int, dim: int):
    """Slab i of n equal slabs of x along `dim` (a view)."""
    if x.shape[dim] % n:
        raise ValueError(f"extent {x.shape[dim]} on dim {dim} does not "
                         f"split into {n} equal slabs")
    m = x.shape[dim] // n
    return x.narrow(dim, i * m, m)


def shard_batch(mesh, batch):
    """This rank's share of a whole batch (a dict / list tree of tensors):
    the leading axis split over 'data' where it divides, and (B, S, D,
    ...) volumes (5 or more dims) also split on D (axis 2) over 'space'
    when that axis is above 1; everything else whole."""
    nd, di = axis_size(mesh, "data"), axis_index(mesh, "data")
    ns, si = axis_size(mesh, "space"), axis_index(mesh, "space")

    def put(x):
        if not torch.is_tensor(x) or x.dim() < 1:
            return x
        if x.shape[0] % nd == 0:
            x = local_slice(x, nd, di, 0)
        if ns > 1 and x.dim() >= 5:
            x = local_slice(x, ns, si, 2)
        return x

    return _map(put, batch)
