"""Weights between the JAX package and the port.

`from_jax_params` turns a flax parameter tree of brainfm_tpu's Joiner
(UNet3D backbone + TaskHead; numpy leaves) into a state dict of the port's
Joiner. Its keys are the reference's state-dict names, the ones
brainfm_tpu/models/torch_import.py::torch_to_flax_params parses, so the
two functions are inverses. Conv kernels go (kd,kh,kw,cin,cout) ->
(cout,cin,kd,kh,kw); dtypes are kept.
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
