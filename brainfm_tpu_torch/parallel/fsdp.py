"""ZeRO/FSDP parameter and optimizer-state sharding (port of
brainfm_tpu/parallel/fsdp.py) on PyTorch's FSDP2 (`fully_shard`).

Every parameter (and so every optimizer moment made beside it) is
sharded over the mesh 'data' axis on its largest evenly divisible
dimension, the JAX package's rule. FSDP2 all-gathers a unit's parameters
for its forward and backward and reduce-scatters the gradients, so the
optimizer update runs on the shards: per-rank state memory drops by the
axis size while the math is unchanged (tests/test_torch_fsdp.py, fp64).
FSDP2's reduce-scatter averages the gradients over 'data' (its default:
a custom divide factor takes PREMUL_SUM for fp32, which gloo lacks), so
the train step scales a sharded model's loss by 1/space only
(train/step.py).
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from .mesh import axis_size


def fsdp_spec(shape, axis_size: int, axis: str = "data"):
    """The dimension to shard over `axis_size` ranks: the largest one
    that it divides (and above 1); None (replicated) when none does."""
    del axis
    best = None
    for d, s in enumerate(shape):
        if s % axis_size == 0 and s > 1:
            if best is None or s > shape[best]:
                best = d
    return best


def state_shardings(model: nn.Module, mesh, axis: str = "data") -> dict:
    """{parameter name: Shard(dim) or Replicate()} under the FSDP rule."""
    from torch.distributed.tensor import Replicate, Shard

    n = axis_size(mesh, axis)
    out = {}
    for name, p in model.named_parameters():
        d = fsdp_spec(tuple(p.shape), n)
        out[name] = Replicate() if d is None else Shard(d)
    return out


def _units(model: nn.Module):
    """The FSDP units: every encoder and decoder level and every head."""
    from ..models.heads import TaskHead
    from ..models.unet3d import Decoder, Encoder

    return [m for m in model.modules()
            if isinstance(m, (Encoder, Decoder, TaskHead))]


def is_sharded(model: nn.Module) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(p, DTensor) for p in model.parameters())


def shard_state(model: nn.Module, mesh, axis: str = "data"):
    """Shard `model` in place with FSDP2 over the mesh's `axis` sub-mesh:
    one fully_shard per encoder / decoder level and head, then one at
    the root, each parameter on fsdp_spec's dimension. A parameter that
    no dimension divides keeps FSDP2's padded Shard(0): the math is
    unchanged, only its memory differs from the JAX package's replicated
    small tensors. A model already sharded is returned as it is."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    if is_sharded(model):
        return model
    sub = mesh[axis]
    n = sub.size()

    def placement(p):
        d = fsdp_spec(tuple(p.shape), n)
        return Shard(0 if d is None else d)

    for m in _units(model):
        fully_shard(m, mesh=sub, shard_placement_fn=placement)
    fully_shard(model, mesh=sub, shard_placement_fn=placement)
    return model


def _local(full, like):
    """This rank's part of `full` for a DTensor laid out as `like`."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(full.to(like.device, like.dtype),
                             like.device_mesh, like.placements,
                             src_data_rank=None)


@torch.no_grad()
def load_full_state(model: nn.Module, state: dict):
    """Copy a full (unsharded) state dict into a sharded model, strict:
    each rank keeps its own shards."""
    from torch.distributed.tensor import DTensor

    own = dict(model.named_parameters())
    own.update(dict(model.named_buffers()))
    missing = set(own) - set(state)
    extra = set(state) - set(own)
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {sorted(missing)}, "
                       f"unexpected {sorted(extra)}")
    for k, t in own.items():
        if isinstance(t, DTensor):
            t.to_local().copy_(_local(state[k], t).to_local())
        else:
            t.copy_(state[k])
    return model


def full_tensor(t):
    """The whole tensor of a DTensor (a collective: every rank calls it
    in the same order); any other value as it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def shard_optimizer_state(state_dict: dict, optimizer) -> dict:
    """A full optimizer state dict (the port's checkpoint format) with
    every parameter-shaped state tensor laid out as its sharded
    parameter, ready for optimizer.load_state_dict."""
    from torch.distributed.tensor import DTensor

    params = [p for g in optimizer.param_groups for p in g["params"]]
    out = dict(state_dict)
    out["state"] = {}
    for i, st in state_dict["state"].items():
        p = params[int(i)]
        out["state"][i] = {
            k: (_local(v, p) if isinstance(p, DTensor) and torch.is_tensor(v)
                and tuple(v.shape) == tuple(p.shape) else v)
            for k, v in st.items()}
    return out


def init_sharded(make_model, mesh, *args, axis: str = "data"):
    """Build `make_model(*args)` (an nn.Module, built where the current
    device context puts it) on the meta device, shard it, and materialise
    only this rank's shards on the mesh's device: the full state never
    exists on a rank, only one full tensor at a time on the host. The
    values equal the replicated build's from the same torch seed: each
    module's reset_parameters is replayed on the host in construction
    order, which draws what the construction drew."""
    with torch.device("meta"):
        ref = make_model(*args)
    if any(True for _ in ref.buffers()):
        raise ValueError("init_sharded takes models without buffers")
    model = copy.deepcopy(ref)
    shard_state(model, mesh, axis)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    model.to_empty(device=dev)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, m in ref.named_modules():
            if not list(m.parameters(recurse=False)):
                continue
            m.to_empty(device="cpu", recurse=False)
            m.reset_parameters()
            for pname, full in m.named_parameters(recurse=False):
                p = params[f"{name}.{pname}" if name else pname]
                p.to_local().copy_(_local(full, p).to_local())
            m.to_empty(device="meta", recurse=False)
    return model
