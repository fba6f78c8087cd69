"""Weights between the JAX package, checkpoint files and the port.

`from_jax_params` turns a flax parameter tree of brainfm_tpu's models
(numpy leaves) into a state dict of the port's: the Joiner (UNet3D or
UNet2D backbone + TaskHead, with the pooled age head), the SepJoiner
(`decoders_normal` / `decoders_pathol`, `head_normal` / `head_pathol`),
the critic (a Joiner) and the two-stage pair ({'pathol': ..., 'task':
...} -> `pathol.*`, `task.*`). Its keys are the reference's state-dict
names, the ones brainfm_tpu/models/torch_import.py::torch_to_flax_params
parses, so the two functions are inverses on the Joiner. Conv kernels go
(kd,kh,kw,cin,cout) -> (cout,cin,kd,kh,kw) (2-D: (kh,kw,cin,cout) ->
(cout,cin,kh,kw)), Dense kernels (in,out) -> (out,in); dtypes are kept.

`from_jax_opt_state` turns the JAX package's optimizer state (optax Adam,
AdamW, SGD or LARS; numpy leaves, or the dicts and lists of a restored
orbax checkpoint) into the state dict of the port's optimizer, so a JAX
run can be continued by the port.

`load_pth` reads a reference `.pth` / `.pt` state dict straight into the
port's Joiner: the port's parameter names are the reference's.
`align_state_dict` is the JAX package's fuzzy aligner
(models/torch_import.py::align_params) on those names, for files whose
names or shapes are not the model's.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LEAF = {("conv", "kernel"): "conv.weight", ("conv", "bias"): "conv.bias",
         ("groupnorm", "scale"): "groupnorm.weight",
         ("groupnorm", "bias"): "groupnorm.bias",
         ("main", "kernel"): "main.weight", ("main", "bias"): "main.bias",
         ("kernel",): "weight", ("bias",): "bias"}


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    else:
        yield prefix, tree


_HEAD = r"(head|head_normal|head_pathol)"
# flax path pattern -> reference key format; the last group is the leaf
_KEYS = (
    (r"backbone/encoders/encoder(\d+)/(SingleConv[12])/(.*)",
     "backbone.encoders.{0}.basic_module.{1}.{2}"),
    (r"backbone/decoders(|_normal|_pathol)/decoder\1(\d+)/(SingleConv[12])"
     r"/(.*)", "backbone.decoders{0}.{1}.basic_module.{2}.{3}"),
    (_HEAD + r"/layer(\d+)/(main/.*)", "{0}.layers.{1}.{2}"),
    (_HEAD + r"/(final_conv_\w+)/(.*)", "{0}.{1}.{2}"),
    # the scalar head's two ConvBlocks sit at pool_layers 1 and 3, after
    # their max-pools
    (_HEAD + r"/pool_conv1_\w+/(main/.*)", "{0}.pool_layers.1.{1}"),
    (_HEAD + r"/pool_conv2_\w+/(main/.*)", "{0}.pool_layers.3.{1}"),
    (_HEAD + r"/(final_linear[123]_\w+)/(.*)", "{0}.{1}.{2}"))
# kernel layouts: flax -> PyTorch, by rank
_KERNEL_AXES = {5: (4, 3, 0, 1, 2), 4: (3, 2, 0, 1), 2: (1, 0)}
STAGES = ("pathol", "task")


def _torch_key(path):
    """flax path -> reference state-dict key."""
    p = "/".join(path)
    for pat, fmt in _KEYS:
        m = re.fullmatch(pat, p)
        if m:
            *lead, leaf = m.groups()
            name = _LEAF.get(tuple(leaf.split("/")))
            if name is not None:
                return fmt.format(*lead, name)
    raise KeyError(f"no port parameter for flax path {p}")


def from_jax_params(params) -> dict:
    """flax params ({'params': tree} or the tree; numpy, JAX or CPU
    tensor leaves) -> state dict. A two-stage tree {'pathol': ...,
    'task': ...} gives `pathol.*` and `task.*` keys, those of the port's
    TwoStage."""
    tree = params.get("params", params)
    if set(tree) == set(STAGES):
        return {f"{stage}.{k}": v for stage in STAGES
                for k, v in from_jax_params(tree[stage]).items()}
    sd = {}
    for path, leaf in _flatten(tree):
        # train/orbax_read.py gives tensors (bfloat16 too)
        t = leaf if torch.is_tensor(leaf) else torch.from_numpy(
            np.array(leaf))
        if path[-1] == "kernel":
            t = t.permute(_KERNEL_AXES[t.dim()])
        sd[_torch_key(path)] = t.clone(memory_format=torch.contiguous_format)
    return sd


def find_state(state, fields):
    """The first node of an optax state tree (namedtuples, tuples, lists,
    dicts) that has every field in `fields`: a namedtuple, or a dict with
    those keys, as an orbax checkpoint restores a namedtuple
    (train/orbax_read.py)."""
    if set(fields) <= set(getattr(state, "_fields", ())) or (
            isinstance(state, dict) and set(fields) <= set(state)):
        return state
    children = (state.values() if isinstance(state, dict)
                else state if isinstance(state, (tuple, list)) else ())
    for c in children:
        hit = find_state(c, fields)
        if hit is not None:
            return hit
    return None


def _field(node, name):
    return node[name] if isinstance(node, dict) else getattr(node, name)


def from_jax_opt_state(opt_state, model, optimizer) -> dict:
    """optax state -> `optimizer.state_dict()` of the port's optimizer over
    `model.parameters()`, in the port's parameter order (a TwoStage's:
    stage 0's, then stage 1's). Adam and AdamW
    (ScaleByAdamState: count, mu, nu) give `step`, `exp_avg` and
    `exp_avg_sq`; SGD and LARS (TraceState: trace) give
    `momentum_buffer`. The param_groups are the optimizer's own."""
    order = {name: i for i, (name, _) in
             enumerate(model.named_parameters())}
    adam = find_state(opt_state, ("count", "mu", "nu"))
    trace = find_state(opt_state, ("trace",))
    if adam is not None:
        trees = {"exp_avg": _field(adam, "mu"),
                 "exp_avg_sq": _field(adam, "nu")}
        step = torch.tensor(float(np.asarray(_field(adam, "count"))))
    elif trace is not None:
        trees, step = {"momentum_buffer": _field(trace, "trace")}, None
    else:
        raise ValueError("no Adam or trace state in the optax state")
    state: dict = {}
    for key, tree in trees.items():
        for name, t in from_jax_params(tree).items():
            st = state.setdefault(order[name], {})
            st[key] = t
            if step is not None:
                st["step"] = step.clone()
    sd = optimizer.state_dict()
    return {"state": state, "param_groups": sd["param_groups"]}


def read_state_dict(path: str):
    """A `.pth` / `.pt` checkpoint as (state dict, bare) (parity:
    torch_import.py::load_torch_state_dict and its key handling): a
    `"model"` entry is unwrapped and a `module.` prefix (DataParallel)
    stripped; `bare` when it holds a backbone alone (UNet keys without
    `backbone.`). The file is read with `weights_only=True`: tensors and
    plain containers only, no pickled code."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    state = {k.removeprefix("module."): v for k, v in state.items()}
    bare = (not any(k.startswith("backbone.") for k in state)
            and any(k.startswith(("encoders.", "decoders")) for k in state))
    return state, bare


def load_pth(model, path: str):
    """Load a `.pth` / `.pt` checkpoint into the joiner `model`, strictly;
    a bare backbone loads into `model.backbone`. Returns the model."""
    state, bare = read_state_dict(path)
    (model.backbone if bare else model).load_state_dict(state, strict=True)
    return model


def align_state_dict(target, ckpt, exclude_key: str | None = None,
                     to_match: dict | None = None):
    """Align the state dict `ckpt` onto the state dict `target`: the rules
    of the JAX package's align_params on the reference's names (those of
    the reference's align_and_update_state_dicts).

    Each model key not containing `exclude_key` takes the longest
    checkpoint key that equals it or ends it after a '.', directly or
    after the `to_match` renames (old -> new substrings). One checkpoint
    key matching two model keys raises ValueError. A shape mismatch at
    equal rank is skipped (`skipped_shape`, the live value stays); a conv
    kernel (O, I, kD, kH, kW) fed a 2-D kernel (O, I, kH, kW) gets it in
    its centre depth frame [:, :, kD // 2] and zeros elsewhere
    (`inflated`). Values take the target's dtype and device.

    Returns (aligned, report): `aligned` has exactly `target`'s keys;
    `report` lists `matched` and `inflated` (model key, checkpoint key)
    pairs, `skipped_shape`, `unmatched_model` and `unmatched_ckpt`."""
    to_match = to_match or {}
    model_keys = sorted(k for k in target
                        if exclude_key is None or exclude_key not in k)
    ckpt_keys = sorted(ckpt)

    def matches(a: str, b: str) -> bool:
        return any(a == c or a.endswith("." + c) for c in
                   [b] + [b.replace(old, new) for old, new in
                          to_match.items()])

    aligned = dict(target)
    owner: dict = {}   # checkpoint key -> model key
    report = {"matched": [], "inflated": [], "skipped_shape": [],
              "unmatched_model": [], "unmatched_ckpt": []}
    for mk in model_keys:
        best = max((ck for ck in ckpt_keys if matches(mk, ck)), key=len,
                   default=None)
        if best is None:
            continue
        if best in owner:
            raise ValueError(
                f"Cannot match one checkpoint key to multiple keys in the "
                f"model: {best} -> {owner[best]} and {mk}")
        t, val = target[mk], torch.as_tensor(ckpt[best])
        shape = tuple(t.shape)
        if shape == tuple(val.shape):
            aligned[mk] = val.to(dtype=t.dtype, device=t.device)
            report["matched"].append((mk, best))
        elif (len(shape) == val.dim() + 1 and len(shape) >= 3
              and shape[:2] + shape[3:] == tuple(val.shape)):
            out = torch.zeros_like(t)
            out[:, :, shape[2] // 2] = val.to(dtype=t.dtype, device=t.device)
            aligned[mk] = out
            report["inflated"].append((mk, best))
        else:
            report["skipped_shape"].append((mk, best))
            continue
        owner[best] = mk
    report["unmatched_model"] = [k for k in model_keys
                                 if k not in set(owner.values())]
    report["unmatched_ckpt"] = [k for k in ckpt_keys if k not in owner]
    return aligned, report
