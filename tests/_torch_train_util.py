"""Shared set-up of tests/test_torch_train.py and tests/test_torch_loop.py:
the joint training config cut to a small model, a random train batch made
with numpy, the JAX package's model and params for it, and the port's model
holding the same params."""

import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from brainfm_tpu.config import load_config as jload
from brainfm_tpu.models import build_model as jbuild
from brainfm_tpu_torch.config import load_config as tload
from brainfm_tpu_torch.config import merge_missing
from brainfm_tpu_torch.models import build_model, from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = (8, 8, 8)


def joint_cfg(load, f_maps=8, num_levels=2, size=SIZE):
    """cfgs/trainer/train/joint.yaml over default_train.yaml with the
    brain_id generator, cut to f_maps `f_maps`, `num_levels` levels and a
    `size` crop; fp64-friendly (no autocast)."""
    gen = load([os.path.join(ROOT, "cfgs/generator/default.yaml"),
                "brain_id"], cfg_dir=os.path.join(ROOT, "cfgs/generator/train"))
    tr = load([os.path.join(ROOT, "cfgs/trainer/default_train.yaml"),
               "joint"], cfg_dir=os.path.join(ROOT, "cfgs/trainer/train"))
    merge_missing(tr, gen)
    tr.f_maps, tr.num_levels, tr.task_f_maps = f_maps, num_levels, [f_maps]
    tr.generator.size = list(size)
    tr.amp = False
    return tr


def np_batch(seed, n_labels, size=SIZE, B=1, S=4):
    """A train batch of numpy arrays. Distance targets stay inside
    (-2.5, 2.5), away from the distance head's clamp at +-3, and the
    softmax of a small random model stays far above the 1e-5 clip of the
    cross-entropy: at those bounds `jnp.clip` splits a tied gradient in
    two where `torch.clamp` passes it whole."""
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


def tree(batch, fn):
    """`fn` on every array of a (nested) batch dict."""
    return {k: tree(v, fn) if isinstance(v, dict) else
            (None if v is None else fn(v)) for k, v in batch.items()}


def to_jax(batch):
    return tree(batch, lambda a: jnp.asarray(np.asarray(a)))


def to_torch(batch):
    return tree(batch, lambda a: torch.from_numpy(np.array(a)))


def jax_model(cfg_over=None, seed=0, **kw):
    """The JAX package's processed cfg, model and fp64 params (numpy)."""
    cfg = joint_cfg(jload, **kw)
    for k, v in (cfg_over or {}).items():
        cfg[k] = v
    jcfg, jm = jbuild(cfg, compute_dtype=jnp.float64)
    x = jnp.zeros((1, *jcfg.generator.size, 1), jnp.float64)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), x)
    return jcfg, jm, jax.tree.map(lambda a: np.asarray(a, np.float64), params)


def port_model(params, cfg_over=None, **kw):
    """The port's processed cfg and fp64 model holding the JAX `params`."""
    cfg = joint_cfg(tload, **kw)
    for k, v in (cfg_over or {}).items():
        cfg[k] = v
    cfg, model = build_model(cfg, device="cpu")
    model = model.double()
    model.load_state_dict(from_jax_params(params), strict=True)
    return cfg, model


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def port_params(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def jax_params_as_port(params):
    return {k: v.numpy() for k, v in from_jax_params(params).items()}
