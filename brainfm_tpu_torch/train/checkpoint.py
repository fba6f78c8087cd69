"""Checkpoints (port of brainfm_tpu/train/checkpoint.py), in the port's own
format: one directory per checkpoint holding

    model.pt    torch.save of the model's state dict
    train.pt    torch.save of {"optimizer": optimizer state dict,
                               "step": TrainState.step}
    extra.json  the JSON extras (epoch, best_val_stats, ...)

Every function keeps its JAX name and contract: rolling `keep` GC,
asynchronous saves finalized by `finalize_pending`, the best checkpoint with
its `_bk` rename, numeric sorting of step directories. Files are read with
`weights_only=True` (tensors and plain containers, no pickled code). The
JAX package's orbax directories are not read here; its weights reach the
port through models/params_io.from_jax_params (and from_jax_opt_state).

Under torch.distributed only rank 0 writes, and the best checkpoint's
rename is fenced by a barrier. A model sharded with FSDP
(parallel/fsdp.py) is gathered to whole tensors first (every rank takes
part), so its checkpoint is the same format and loads into a
single-device run; loading into a sharded model keeps each rank's shards.
"""

from __future__ import annotations

import glob
import json
import os
import re
import shutil
import threading

import torch

from ..parallel.mesh import process_count, process_index

MODEL_FILE = "model.pt"
TRAIN_FILE = "train.pt"


class _Pending:
    """The one asynchronous save in flight (at most one): its thread, and
    the filesystem work deferred until it is durable."""

    def __init__(self):
        self.lock = threading.Lock()
        self.job = None   # (thread, errors, path, keep, ckpt_dir)


_PENDING = _Pending()


def _to_cpu(obj):
    """A copy of a (nested) state dict with every tensor on the CPU (a
    DTensor gathered whole: a collective)."""
    if torch.is_tensor(obj):
        from ..parallel.fsdp import full_tensor

        return full_tensor(obj.detach()).to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _snapshot(state):
    """(model, train) state dicts on the host. On a rank other than 0 of a
    model that is not sharded nothing is copied: (None, None)."""
    from ..parallel.fsdp import is_sharded

    if process_index() != 0 and not is_sharded(state.model):
        return None, None
    return (_to_cpu(state.model.state_dict()),
            {"optimizer": _to_cpu(state.optimizer.state_dict()),
             "step": int(state.step)})


def _write(path, model_sd, train_sd):
    """Write into a temporary sibling, then move it into place, so a
    checkpoint directory is whole or absent."""
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(model_sd, os.path.join(tmp, MODEL_FILE))
    torch.save(train_sd, os.path.join(tmp, TRAIN_FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def _step_dirs(ckpt_dir):
    """Step checkpoint directories, oldest first (numeric: a name sort puts
    ckpt_1000000 before ckpt_999999). The digit pattern keeps ckpt_best and
    ckpt_best_bk out."""
    return sorted((p for p in glob.glob(os.path.join(ckpt_dir, "ckpt_[0-9]*"))
                   if "tmp" not in os.path.basename(p) and os.path.isdir(p)),
                  key=step_from_path)


def finalize_pending():
    """Block until the in-flight asynchronous save (if any) is on disk,
    move its sidecar extra.json into the checkpoint directory and run the
    rolling GC. Raises what the save raised."""
    with _PENDING.lock:
        job, _PENDING.job = _PENDING.job, None
    if job is None:
        return
    thread, errors, path, keep, ckpt_dir = job
    thread.join()
    if errors:
        raise errors[0]
    side = path + ".extra.json"
    if os.path.isfile(side) and os.path.isdir(path):
        os.replace(side, os.path.join(path, "extra.json"))
    if keep > 0:
        for p in _step_dirs(ckpt_dir)[:-keep]:
            shutil.rmtree(p, ignore_errors=True)
            if os.path.isfile(p + ".extra.json"):
                os.remove(p + ".extra.json")


def save_checkpoint(ckpt_dir: str, step: int, state, extra: dict | None = None,
                    keep: int = 0, block: bool = True):
    """Save the model, optimizer and step (+ JSON extras) at
    `ckpt_dir/ckpt_{step:06d}`.

    `keep`: if > 0, remove older step checkpoints so at most `keep` remain
    (best checkpoints are never removed). `block=False` returns once the
    state is copied to host memory and writes the files on a background
    thread while training goes on; the previous asynchronous save is
    always finalized first, so at most one is in flight. The extras are
    written at once as a sidecar, so a crash before the finalize keeps
    them."""
    finalize_pending()
    ckpt_dir = os.path.abspath(ckpt_dir)
    path = os.path.join(ckpt_dir, f"ckpt_{step:06d}")
    model_sd, train_sd = _snapshot(state)
    if process_index() != 0:
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    if extra:
        with open(path + ".extra.json", "w") as f:
            json.dump(extra, f)
    errors = []

    def run():
        try:
            _write(path, model_sd, train_sd)
        except Exception as e:   # raised again by finalize_pending
            errors.append(e)

    thread = threading.Thread(target=run, name="save_checkpoint")
    thread.start()
    with _PENDING.lock:
        _PENDING.job = (thread, errors, path, keep, ckpt_dir)
    if block:
        finalize_pending()
    return path


def save_best_checkpoint(ckpt_dir: str, step: int, state,
                         extra: dict | None = None):
    """Save the new best checkpoint at `ckpt_dir/ckpt_best`, renaming the
    previous best to ckpt_best_bk first. `step` is unused, as in the JAX
    package: the state's own step is saved."""
    del step
    finalize_pending()
    ckpt_dir = os.path.abspath(ckpt_dir)
    best = os.path.join(ckpt_dir, "ckpt_best")
    bk = os.path.join(ckpt_dir, "ckpt_best_bk")
    snap = _snapshot(state)
    if process_index() == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.isdir(best):
            shutil.rmtree(bk, ignore_errors=True)
            os.rename(best, bk)
        _write(best, *snap)
        if extra:
            with open(os.path.join(best, "extra.json"), "w") as f:
                json.dump(extra, f)
    if process_count() > 1:
        torch.distributed.barrier()
    return best


def read_extra(path: str) -> dict:
    """The JSON extras saved with a checkpoint; {} if absent. The canonical
    in-directory extra.json first, then the save-time sidecar (present when
    a run died before the asynchronous save was finalized)."""
    path = os.path.abspath(path)
    for p in (os.path.join(path, "extra.json"), path + ".extra.json"):
        if os.path.isfile(p):
            with open(p) as f:
                return json.load(f)
    return {}


def latest_checkpoint(ckpt_dir: str):
    """The newest step checkpoint directory, or None."""
    finalize_pending()   # an in-flight save exists only as a tmp dir
    paths = _step_dirs(ckpt_dir)
    return paths[-1] if paths else None


def load_checkpoint(path: str, state):
    """Restore a checkpoint into `state` (a TrainState of a model and
    optimizer built like the saved ones) and return it. The weights load
    onto the model's device; the optimizer state goes through
    `load_state_dict`, which places it as the optimizer keeps it (moments
    beside their parameters, step counts on the CPU)."""
    from .step import TrainState

    from ..parallel.fsdp import is_sharded, shard_optimizer_state

    load_model_weights(path, state.model)
    train_sd = torch.load(os.path.join(path, TRAIN_FILE), map_location="cpu",
                          weights_only=True)
    opt_sd = train_sd["optimizer"]
    if is_sharded(state.model):
        opt_sd = shard_optimizer_state(opt_sd, state.optimizer)
    state.optimizer.load_state_dict(opt_sd)
    return TrainState(state.model, state.optimizer, int(train_sd["step"]))


def load_model_weights(path: str, model):
    """Load only the model weights of a checkpoint directory into `model`
    (strict; a sharded model keeps its shards). Returns the model."""
    from ..parallel.fsdp import is_sharded, load_full_state

    if is_sharded(model):
        return load_full_state(model, torch.load(
            os.path.join(path, MODEL_FILE), map_location="cpu",
            weights_only=True))
    dev = next(model.parameters()).device
    model.load_state_dict(torch.load(os.path.join(path, MODEL_FILE),
                                     map_location=dev, weights_only=True),
                          strict=True)
    return model


def is_checkpoint_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(str(path), MODEL_FILE))


def step_from_path(path: str) -> int:
    m = re.search(r"ckpt_(\d+)", path)
    return int(m.group(1)) if m else 0
