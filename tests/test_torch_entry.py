"""The port's driver contract (brainfm_tpu_torch/entry.py) against the
repo's `__graft_entry__.py`, on the CPU.

- `entry(device="cpu")`'s parameter names, shapes and dtypes are what
  `from_jax_params` makes of the JAX `entry()`'s, at the flagship's full
  width; its `fn` at a small size (f_maps 8, 3 levels, 32^3) equals the
  JAX `fn` on weights from one JAX init, both at fp32 compute (bf16 is not
  compared: the two autocasts round differently), within 1e-4 of the
  output's largest magnitude.
- `dryrun_multichip(2)` and `(4)` on gloo CPU ranks: finite losses, the
  FSDP loss equal to the data-parallel one; the data-parallel loss on the
  JAX dry run's numpy batch with JAX weights carried across equals the
  JAX `make_train_step` loss within 1e-5 relative; the conv tower equals
  the JAX tower on the same draws.
- The dry run's configs are the JAX dry run's literals (read with `ast`);
  without cards `dryrun_multichip` raises and names `device="cpu"`;
  importing the module loads no torch.
"""

import ast
import inspect
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from brainfm_tpu_torch import entry as port_entry
from brainfm_tpu_torch.models.params_io import from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"generator": {"left_hemis_only": False, "size": [32, 32, 32]},
         "f_maps": 8, "num_levels": 3, "task_f_maps": [8]}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_model(cfg_dict):
    import jax.numpy as jnp

    from brainfm_tpu.config import AttrDict
    from brainfm_tpu.models import build_model

    return build_model(AttrDict.from_nested(json.loads(json.dumps(
        cfg_dict))), compute_dtype=jnp.float32)


@pytest.fixture(scope="module")
def dryruns(tmp_path_factory):
    """dryrun_multichip(2) (torch's init) and (4) (weights of one JAX init
    of the dry run's model, on the JAX batch's first item), run while the
    JAX dry run's loss is computed here. Returns (results by n, JAX
    loss)."""
    import jax
    import jax.numpy as jnp

    from brainfm_tpu.models.criterion import make_criterion
    from brainfm_tpu.train.step import (TrainState, build_optimizer,
                                        make_train_step)

    cfg, model = _jax_model(port_entry.dryrun_cfg())
    data, space = port_entry.mesh_shape(4)
    np_batch, _ = port_entry.numpy_draws(data, space, cfg.n_labels)
    batch = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), np_batch)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 batch["samples"]["input"][0])
    path = str(tmp_path_factory.mktemp("entry") / "jax_weights.pt")
    torch.save(from_jax_params(jax.device_get(params)), path)

    # one thread a rank: six ranks and the JAX compile share the host
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(2) as pool:
        mp.setenv("OMP_NUM_THREADS", "1")
        runs = {2: pool.submit(port_entry.dryrun_multichip, 2, "cpu"),
                4: pool.submit(port_entry.dryrun_multichip, 4, "cpu",
                               weights=path)}
        _, wd, loss_fn = make_criterion(cfg)
        opt = build_optimizer(cfg)
        state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
        step = make_train_step(model, cfg, wd, loss_fn, opt, donate=False)
        _, metrics = step(state, batch, jnp.float32(1e-4), jnp.float32(0.0))
        jax_loss = float(metrics["loss_total"])
        res = {n: f.result() for n, f in runs.items()}
    return res, jax_loss


def test_entry_params_are_the_jax_entry_params(monkeypatch):
    fn, (params, x) = port_entry.entry(device="cpu")
    got = {k: (tuple(v.shape), v.dtype) for k, v in params.items()}
    assert all(not v.any() for v in params.values())
    assert tuple(x.shape) == (1, 160, 160, 160, 1) and x.dtype == torch.float32
    del fn, params, x

    import brainfm_tpu.utils.cache as cache

    monkeypatch.setattr(cache, "setup_compilation_cache", lambda *a, **k: None)
    _, (jparams, jx) = graft.entry()
    assert jx.shape == (1, 160, 160, 160, 1)
    want = {k: (tuple(v.shape), v.dtype)
            for k, v in from_jax_params(jparams).items()}
    assert got == want
    assert {d for _, d in got.values()} == {torch.float32}


def test_entry_fn_equals_the_jax_fn_at_fp32():
    import jax

    cfg, model = _jax_model({**graft._JOINT_CFG, **SMALL})
    x = np.random.default_rng(3).random((1, 32, 32, 32, 1)).astype(
        np.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), x)
    out = jax.jit(model.apply)(params, x)
    jt1, jseg = out["T1"], out["segmentation"]

    fn, (zeros, x0) = port_entry.entry(device="cpu", overrides=SMALL,
                                       amp=False)
    assert x0.shape == x.shape
    sd = from_jax_params(jax.device_get(params))
    assert set(sd) == set(zeros)
    with torch.no_grad():
        t1, seg = fn(sd, torch.from_numpy(x))
        z1, zseg = fn(zeros, torch.from_numpy(x))
    for got, want in ((t1, jt1), (seg, jseg)):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err < 1e-4, err
    # zero parameters: constant fields
    assert not z1.any() and not zseg.any()


def test_dryrun_losses_finite_and_fsdp_agrees(dryruns):
    res, _ = dryruns
    for n, r in res.items():
        data, space = port_entry.mesh_shape(n)
        assert r["mesh"] == {"data": data, "space": space}
        for k in ("loss_total", "fsdp_loss_total", "space_loss_total",
                  "synth_loss_total"):
            assert np.isfinite(r[k]), (n, k)
        np.testing.assert_allclose(r["fsdp_loss_total"], r["loss_total"],
                                   rtol=1e-5)
        assert len(r["launches_by_rank"]) == n


def test_dryrun_dp_loss_equals_the_jax_step_loss(dryruns):
    res, jax_loss = dryruns
    np.testing.assert_allclose(res[4]["loss_total"], jax_loss, rtol=1e-5)


def test_dryrun_conv_tower_equals_the_jax_tower(dryruns):
    import jax.numpy as jnp

    def conv_apply(x):   # __graft_entry__.dryrun_multichip's tower
        y = x
        for _ in range(3):
            yp = jnp.pad(y, ((0, 0), (1, 1), (0, 0), (0, 0), (0, 0)))
            y = yp[:, :-2] + 2.0 * yp[:, 1:-1] + yp[:, 2:]
        return y

    res, _ = dryruns
    for n, r in res.items():
        data, space = port_entry.mesh_shape(n)
        _, xs = port_entry.numpy_draws(data, space, 56)
        want = np.asarray(conv_apply(jnp.asarray(xs, jnp.float32)))
        got = r["tower"].numpy()
        assert got.shape == (1, 32, 16, 16, 1)
        np.testing.assert_allclose(got[:, 3:-3], want[:, 3:-3], rtol=1e-6)


def _graft_cfgs():
    """The two config dicts of the JAX dry run, evaluated from its
    source."""
    fn = next(n for n in ast.walk(ast.parse(inspect.getsource(graft)))
              if isinstance(n, ast.FunctionDef)
              and n.name == "dryrun_multichip")
    calls = [c for c in ast.walk(fn) if isinstance(c, ast.Call)
             and isinstance(c.func, ast.Attribute)
             and c.func.attr == "from_nested"]
    env = {"_JOINT_CFG": graft._JOINT_CFG, "size": (16, 16, 16),
           "list": list}
    return [eval(compile(ast.Expression(c.args[0]), "graft", "eval"), env)
            for c in sorted(calls, key=lambda c: c.lineno)]


def test_dryrun_configs_are_the_jax_literals():
    dp, syn = _graft_cfgs()
    assert json.loads(json.dumps(port_entry.dryrun_cfg())) == dp
    assert json.loads(json.dumps(port_entry.synth_cfg())) == syn
    assert port_entry._JOINT_CFG == graft._JOINT_CFG
    for n in (1, 2, 3, 4, 8):
        space = 2 if n % 2 == 0 and n > 1 else 1
        assert port_entry.mesh_shape(n) == (n // space, space)


def test_dryrun_without_enough_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_entry.dryrun_multichip(1)


def test_import_loads_no_torch():
    code = ("import sys; import brainfm_tpu_torch.entry as e; "
            "assert callable(e.entry) and callable(e.dryrun_multichip); "
            "assert 'torch' not in sys.modules, 'torch'; "
            "assert not any(m == 'jax' or m.startswith(('jax.', "
            "'brainfm_tpu.')) or m in ('brainfm_tpu', '__graft_entry__') "
            "for m in sys.modules), sorted(sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-2000:]


def test_dryrun_a_failing_rank_raises_with_its_output(tmp_path):
    # a weights file that is not there: every rank fails at its load
    with pytest.raises(RuntimeError, match=r"rank \d \(exit 1\)") as e:
        port_entry.dryrun_multichip(2, device="cpu", timeout=120,
                                    weights=str(tmp_path / "missing.pt"))
    assert "missing.pt" in str(e.value)


def test_dryrun_a_rank_past_its_deadline_is_stopped(tmp_path):
    sleeper = [subprocess.Popen([sys.executable, "-c",
                                 "import time; time.sleep(60)"])]
    try:
        assert port_entry._wait_ranks(sleeper, 0.5) == [
            (0, "still running after 0.5 s")]
    finally:
        sleeper[0].kill()
        sleeper[0].wait()
