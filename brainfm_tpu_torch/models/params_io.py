"""Weights between the JAX package, checkpoint files and the port.

`from_jax_params` turns a flax parameter tree of brainfm_tpu's Joiner
(UNet3D backbone + TaskHead; numpy leaves) into a state dict of the port's
Joiner. Its keys are the reference's state-dict names, the ones
brainfm_tpu/models/torch_import.py::torch_to_flax_params parses, so the
two functions are inverses. Conv kernels go (kd,kh,kw,cin,cout) ->
(cout,cin,kd,kh,kw); dtypes are kept.

`load_pth` reads a reference `.pth` / `.pt` state dict straight into the
port's Joiner: the port's parameter names are the reference's.
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


def _torch_key(path):
    """flax path -> reference state-dict key."""
    p = "/".join(path)
    for pat, fmt in (
            (r"backbone/encoders/encoder(\d+)/(SingleConv[12])/(.*)",
             "backbone.encoders.{0}.basic_module.{1}.{2}"),
            (r"backbone/decoders/decoder(\d+)/(SingleConv[12])/(.*)",
             "backbone.decoders.{0}.basic_module.{1}.{2}"),
            (r"head/layer(\d+)/(main/.*)", "head.layers.{0}.{1}"),
            (r"head/(final_conv_\w+)/(.*)", "head.{0}.{1}")):
        m = re.fullmatch(pat, p)
        if m:
            *lead, leaf = m.groups()
            name = _LEAF.get(tuple(leaf.split("/")))
            if name is not None:
                return fmt.format(*lead, name)
    raise KeyError(f"no port parameter for flax path {p}")


def from_jax_params(params) -> dict:
    """flax params ({'params': tree} or the tree) -> state dict."""
    tree = params.get("params", params)
    sd = {}
    for path, leaf in _flatten(tree):
        a = np.asarray(leaf)
        if path[-1] == "kernel":
            a = np.transpose(a, (4, 3, 0, 1, 2))
        sd[_torch_key(path)] = torch.from_numpy(np.array(a))  # a writable copy
    return sd


def load_pth(model, path: str):
    """Load a `.pth` / `.pt` checkpoint into the Joiner `model` (parity:
    torch_import.py::load_torch_state_dict and its key handling): a
    `"model"` entry is unwrapped, a `module.` prefix (DataParallel) is
    stripped, and a bare backbone (UNet3D keys without `backbone.`) loads
    into `model.backbone`. Loading is strict. The file is read with
    `weights_only=True`: tensors and plain containers only, no pickled
    code. Returns the model."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    state = {k.removeprefix("module."): v for k, v in state.items()}
    bare = (not any(k.startswith("backbone.") for k in state)
            and any(k.startswith(("encoders.", "decoders")) for k in state))
    (model.backbone if bare else model).load_state_dict(state, strict=True)
    return model
