"""Write the committed orbax fixtures of tests/fixtures/torch_orbax/ with the
JAX package's own TrainState and save_checkpoint (not collected by pytest:
no test_ prefix):

    python tests/_torch_orbax_fixtures.py [OUT_DIR]

- small/ckpt_000003: the tests' small joint config (joint.yaml over
  brain_id, f_maps 8, 3 levels, unit_feat off) with random weights from
  PRNGKey(0) and an AdamW state whose moments are random multiples of
  powers of two (so they compress), count and step 3; small_outputs.npz:
  the JAX Inferencer's fp32 outputs served from that directory on a 32^3
  input from default_rng(0).
- twostage/ckpt_000000: twostage.yaml with its generator cut the same
  way, one TrainState with params {pathol, task} (initialised as the JAX
  loop does); twostage_outputs.npz: the JAX TwoStageInferencer's outputs
  from that directory on the same input.
- flagship/ckpt_000000: joint.yaml at full width (f_maps 64, 6 levels, 8
  tasks, 264.1 M parameters) with every parameter and AdamW moment zero.

The .npz files hold every float output at SAMPLES voxels (`voxels`, flat
indices from default_rng(1)) and the label map whole: the whole float
outputs (9.2 MB a model) would not fit the fixtures' 4 MB.

The port's read of weights that do not compress, as trained fp32 weights
do not (3.2 GB on disk; not a fixture):

    python tests/_torch_orbax_fixtures.py random-flagship DIR
    python tests/_torch_orbax_fixtures.py time-read DIR [REPEATS]

The first writes DIR/ckpt_000000, the flagship architecture's TrainState
with every parameter and AdamW moment random normal fp32; the second
times `orbax_read.restore` on it, params only and the full state, and
the decoder on the largest chunk alone on one thread, and prints one JSON
line per repeat.
"""

import os
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from brainfm_tpu.config import load_config as jload  # noqa: E402
from brainfm_tpu.infer import api as japi  # noqa: E402
from brainfm_tpu.models import build_model  # noqa: E402
from brainfm_tpu.models.build import build_inpaint_model  # noqa: E402
from brainfm_tpu.train.checkpoint import save_checkpoint  # noqa: E402
from brainfm_tpu.train.step import TrainState, build_optimizer  # noqa: E402

from _torch_train_util import joint_cfg  # noqa: E402

OUT = os.path.join(ROOT, "tests", "fixtures", "torch_orbax")
SIZE = (32, 32, 32)
SAMPLES = 2048
SMALL_STEP = 3


def _served(cfg):
    # the unit-vector normalization of the last features divides by norms
    # that are small at some voxels, magnifying fp32 rounding past what an
    # fp32 comparison across packages and devices can hold (the serving
    # tests turn it off for the same reason); it holds no parameters
    cfg.unit_feat = False
    return cfg


def small_cfg():
    return _served(joint_cfg(jload, f_maps=8, num_levels=3, size=SIZE))


def twostage_cfg():
    return _served(joint_cfg(jload, f_maps=8, num_levels=3, size=SIZE,
                             gen="twostage", train="twostage"))


def flagship_cfg():
    return joint_cfg(jload, f_maps=64, num_levels=6, size=(160, 160, 160))


def serve_input():
    return np.random.default_rng(0).random(SIZE).astype(np.float32)


def voxels():
    return np.sort(np.random.default_rng(1).choice(
        int(np.prod(SIZE)), SAMPLES, replace=False))


def _random_moments(state, rng, count):
    """The optax state with every ScaleByAdamState's mu and nu random
    multiples of 2^-14 and 2^-20 and its count (and the injected
    hyperparameters' count) set to `count`."""
    if isinstance(state, optax.ScaleByAdamState):
        def mu(a):
            return jnp.asarray(rng.integers(-128, 128, a.shape) * 2.0 ** -14,
                               a.dtype)

        def nu(a):
            return jnp.asarray(rng.integers(1, 128, a.shape) * 2.0 ** -20,
                               a.dtype)

        return state._replace(count=jnp.asarray(count, jnp.int32),
                              mu=jax.tree.map(mu, state.mu),
                              nu=jax.tree.map(nu, state.nu))
    if hasattr(state, "_fields"):
        kids = {f: _random_moments(getattr(state, f), rng, count)
                for f in state._fields}
        if "count" in kids and not isinstance(state, optax.ScaleByAdamState):
            kids["count"] = jnp.asarray(count, jnp.int32)
        return type(state)(**kids)
    if isinstance(state, tuple):
        return tuple(_random_moments(s, rng, count) for s in state)
    return state


def _sampled(out):
    idx = voxels()
    res = {"voxels": idx}
    for k, v in out.items():
        if k.startswith("feat"):
            continue
        v = np.asarray(v)
        if k == "label":
            res[k] = v
        else:
            res[k] = v.reshape(-1, v.shape[-1])[idx].astype(np.float32)
    return res


def write_small(out):
    cfg = small_cfg()
    jcfg, model = build_model(cfg)
    opt = build_optimizer(jcfg)
    x = jnp.zeros((1, *SIZE, 1), jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), x)
    state = TrainState(params, _random_moments(
        opt.init(params), np.random.default_rng(2), SMALL_STEP),
        jnp.asarray(SMALL_STEP, jnp.int32))
    path = save_checkpoint(os.path.join(out, "small"), SMALL_STEP, state,
                           extra={"epoch": 0})
    inf = japi.Inferencer(small_cfg(), ckpt_path=path)
    np.savez_compressed(os.path.join(out, "small_outputs.npz"), **_sampled(
        inf.evaluate_image(serve_input(), keep_feat=False)))


def write_twostage(out):
    cfg = twostage_cfg()
    jcfg, pm, tm = build_inpaint_model(cfg)
    opt = build_optimizer(jcfg)
    x = jnp.zeros((1, *SIZE, 1), jnp.float32)
    r1, r2 = jax.random.split(jax.random.PRNGKey(1))
    params = {"pathol": pm.init(r1, x),
              "task": tm.init(r2, x, cond=jnp.zeros_like(x))}
    state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    path = save_checkpoint(os.path.join(out, "twostage"), 0, state)
    inf = japi.TwoStageInferencer(twostage_cfg(), pathol_ckpt=path,
                                  task_ckpt=path)
    np.savez_compressed(os.path.join(out, "twostage_outputs.npz"),
                        **_sampled(inf.evaluate_image(serve_input())))


def write_flagship(out):
    jcfg, model = build_model(flagship_cfg())
    e = 2 ** 5
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, e, e, e, 1),
                                                 jnp.float32))
    params = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    state = TrainState(params, build_optimizer(jcfg).init(params),
                       jnp.zeros((), jnp.int32))
    save_checkpoint(os.path.join(out, "flagship"), 0, state,
                    extra={"epoch": 0})


def write_random_flagship(out):
    jcfg, model = build_model(flagship_cfg())
    e = 2 ** 5
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, e, e, e, 1),
                                                 jnp.float32))
    opt_state = jax.eval_shape(build_optimizer(jcfg).init, params)
    rng = np.random.default_rng(0)

    def fill(s):
        if not jnp.issubdtype(s.dtype, jnp.floating):
            return jnp.zeros(s.shape, s.dtype)
        return jnp.asarray(0.02 * rng.standard_normal(s.shape, np.float32))

    state = TrainState(jax.tree.map(fill, params),
                       jax.tree.map(fill, opt_state), jnp.zeros((), jnp.int32))
    save_checkpoint(out, 0, state, extra={"epoch": 0})


def time_read(out, repeats=2):
    import json
    import time

    import torch

    from brainfm_tpu_torch.runtime import zstd
    from brainfm_tpu_torch.train import orbax_read

    path = os.path.join(out, "ckpt_000000")
    real = zstd.decode_batch
    batch = []

    def captured(frames, sizes):
        batch[:] = [(frames, sizes)]
        return real(frames, sizes)

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(nbytes(v) for v in tree)
        return tree.numel() * tree.element_size() if torch.is_tensor(tree) \
            else np.asarray(tree).nbytes

    for _ in range(int(repeats)):
        orbax_read.zstd.decode_batch = captured
        try:
            t0 = time.perf_counter()
            tree = orbax_read.restore(path, ("params",))
            params_s = time.perf_counter() - t0
        finally:
            orbax_read.zstd.decode_batch = real
        params_bytes = nbytes(tree)
        del tree
        t0 = time.perf_counter()
        tree = orbax_read.restore(path)
        full_s = time.perf_counter() - t0
        full_bytes = nbytes(tree)
        del tree
        frames, sizes = batch[0]
        big = max(range(len(sizes)), key=sizes.__getitem__)
        t0 = time.perf_counter()
        zstd.decompress(frames[big], sizes[big])
        chunk_s = time.perf_counter() - t0
        print(json.dumps({
            "threads": zstd.THREADS, "cores": os.cpu_count(),
            "params_bytes": params_bytes, "params_s": params_s,
            "params_mb_s": params_bytes / params_s / 1e6,
            "params_stored_bytes": sum(len(f) for f in frames),
            "full_bytes": full_bytes, "full_s": full_s,
            "full_mb_s": full_bytes / full_s / 1e6,
            "chunk_bytes": sizes[big], "chunk_stored_bytes": len(frames[big]),
            "chunk_s": chunk_s, "chunk_mb_s": sizes[big] / chunk_s / 1e6}),
            flush=True)
        del frames, sizes, batch[:]


def main(out=OUT):
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    write_small(out)
    write_twostage(out)
    write_flagship(out)
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(out) for f in fs)
    print(f"{out}: {total} bytes")


if __name__ == "__main__":
    if sys.argv[1:2] == ["random-flagship"]:
        write_random_flagship(sys.argv[2])
    elif sys.argv[1:2] == ["time-read"]:
        time_read(*sys.argv[2:4])
    else:
        main(*sys.argv[1:2])
