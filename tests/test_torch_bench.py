"""The port's measuring entry points on the CPU: the bench refuses to run
without CUDA, writing no contract line, and `python -m
brainfm_tpu_torch.bench --smoke --device cpu` writes only contract lines
to stdout and a summary with every key of the root bench.py's; its shapes
and configurations are the root bench's literals, read from that file's
source (nothing of JAX is imported); the roofline twin's FLOP count of a
small UNet3D is the sum of 2 k^3 Cin Cout voxels over its convolutions,
on the CPU and on the meta device; the stage split of the forward runs
every stage at the bench's smoke shapes."""

import ast
import json
import math
import os
import re
import subprocess
import sys

import pytest
import torch

from brainfm_tpu_torch import bench
from brainfm_tpu_torch.models import build_model
from brainfm_tpu_torch.models.unet3d import UNet3D
from brainfm_tpu_torch.scripts import profile_infer, roofline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "bench.py")) as _f:
    ROOT_BENCH = _f.read()
CONTRACT_KEYS = {"metric", "value", "unit", "vs_baseline"}


def _bench(*args, env=None):
    return subprocess.run([sys.executable, "-m", "brainfm_tpu_torch.bench",
                           *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env=env)


def test_bench_refuses_without_cuda(monkeypatch, capsys):
    """In this process, with CUDA hidden: the standard output's routing
    to standard error is the smoke test's (a child process)."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r, w = os.pipe()
    try:
        rc = bench.main([], out_fd=w)
    finally:
        os.close(w)
    with os.fdopen(r) as f:
        written = f.read()
    assert rc != 0
    assert written == ""
    assert "CUDA is not available" in capsys.readouterr().err


@pytest.fixture(scope="module")
def smoke():
    # two threads: the suite runs beside other workers
    return _bench("--smoke", "--device", "cpu",
                  env=dict(os.environ, OMP_NUM_THREADS="2"))


def test_bench_smoke_prints_the_contract_and_every_root_key(smoke):
    out = smoke
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert len(lines) == 2   # after the primary stage, and last
    for line in lines:
        c = json.loads(line)
        assert set(c) == CONTRACT_KEYS
        assert c["metric"] == "inference_vols_per_sec_per_chip"
    last = json.loads(lines[-1])
    assert math.isfinite(last["value"]) and last["value"] > 0
    assert "on cpu" in last["unit"]

    tail = out.stderr.strip().splitlines()[-1]
    assert tail.startswith("# BENCH SUMMARY ")
    summary = json.loads(tail[len("# BENCH SUMMARY "):])
    keys = set(re.findall(r'STAGES\["(\w+)"\]', ROOT_BENCH))
    assert len(keys) == 13
    assert keys <= set(summary)
    assert summary["cache_cold"] is None
    for k in keys - {"cache_cold"}:
        assert math.isfinite(summary[k]), k
    for k in ("whole_volume_ms", "train_step_ms", "train_step_flagship_ms",
              "generator_ms_per_item", "generator_pathol_ms_per_item",
              "tiled_fp32_ms"):
        assert summary[f"{k}_min"] <= summary[k] <= summary[f"{k}_max"], k
    assert summary["failed"] == [] and summary["device"] == "cpu"
    assert set(summary["launches"]) == set(bench.STAGES)


def _root_places():
    """{key: decimal places} of every `round` the root bench writes: the
    STAGES keys and the contract line's `value` and `vs_baseline`."""
    places = {}
    for node in ast.walk(ast.parse(ROOT_BENCH)):
        pairs = []
        if isinstance(node, ast.Assign) and isinstance(
                node.targets[0], ast.Subscript) and isinstance(
                node.targets[0].value, ast.Name) and \
                node.targets[0].value.id == "STAGES":
            pairs.append((ast.literal_eval(node.targets[0].slice),
                          node.value))
        elif isinstance(node, ast.Dict):
            pairs += [(ast.literal_eval(k), v)
                      for k, v in zip(node.keys, node.values)
                      if isinstance(k, ast.Constant)
                      and k.value in ("value", "vs_baseline")]
        for key, v in pairs:
            if isinstance(v, ast.Call) and getattr(v.func, "id", "") == \
                    "round":
                places[key] = (ast.literal_eval(v.args[1])
                               if len(v.args) > 1 else 0)
    return places


def test_bench_keys_carry_the_root_bench_places(smoke):
    root = _root_places()
    # every STAGES key but cache_cold, and the contract line's value
    assert len(root) == 13, root
    assert {k: bench.PLACES[k] for k in root} == root
    # the keys the root bench lacks take their sibling's places
    assert bench.PLACES["train_step_flagship_ms"] == root["train_step_ms"]
    assert bench.PLACES["train_flagship_compile_s"] == root["train_compile_s"]
    assert smoke.returncode == 0, smoke.stderr[-3000:]
    summary = json.loads(smoke.stderr.strip().splitlines()[-1][
        len("# BENCH SUMMARY "):])
    contract = json.loads(smoke.stdout.splitlines()[-1])
    seen = 0
    for k, v in list(summary.items()) + [("value", contract["value"]),
                                         ("vs_baseline",
                                          contract["vs_baseline"])]:
        base = re.sub(r"_(min|max)$", "", k)
        if base not in bench.PLACES:
            continue
        n = bench.PLACES[base]
        assert v == bench.rounded(k, v), (k, v)
        assert isinstance(v, int) if n == 0 else isinstance(v, float), k
        seen += 1
    # every key once (vs_baseline in the summary and the contract), and
    # _min and _max of the 7 timed keys
    assert seen == len(bench.PLACES) + 1 + 2 * 7
    assert bench.rounded("whole_volume_ms_max", 540.6) == 541
    assert bench.rounded("generator_ms_per_item", 40.44) == 40.4
    assert bench.rounded("vs_baseline", 2.123456) == 2.1235


def _root_run():
    tree = ast.parse(ROOT_BENCH)
    return next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == "_run")


def _in_order(node, kind):
    return sorted((n for n in ast.walk(node) if isinstance(n, kind)),
                  key=lambda n: (n.lineno, n.col_offset))


def test_bench_shapes_and_configs_are_the_root_bench_literals():
    run = _root_run()
    names = {"VOL": ("vol",), "WIN": ("win",), "STRIDE": ("stride",),
             "FM": ("f_maps",), "NL": ("num_levels",),
             "GSIZE": ("gen_size",), "TSIZE": ("train_size",)}
    root = {"smoke": {}, "full": {}}
    bound = {"smoke": {}, "full": {}}
    for node in run.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.IfExp):
            t = node.targets[0]
            tnames = ([e.id for e in t.elts] if isinstance(t, ast.Tuple)
                      else [t.id])
            for size, expr in (("smoke", node.value.body),
                               ("full", node.value.orelse)):
                vals = ast.literal_eval(expr)
                vals = vals if len(tnames) > 1 else (vals,)
                for n, v in zip(tnames, vals):
                    bound[size][n] = v
                    root[size][names[n][0]] = v
    assert root == bench.SHAPES

    # the served and the trained model's configs, with each shape's names
    calls = [c for c in _in_order(run, ast.Call)
             if isinstance(c.func, ast.Attribute)
             and c.func.attr == "from_nested"]
    assert len(calls) == 2
    for size, shape in bench.SHAPES.items():
        env = dict(bound[size], list=list)
        for call, base, crop in ((calls[0], bench.INFER_CFG, shape["win"]),
                                 (calls[1], bench.TRAIN_CFG,
                                  shape["train_size"])):
            want = eval(compile(ast.Expression(call.args[0]), "bench.py",
                                "eval"), env)
            assert json.loads(json.dumps(bench.model_cfg(base, shape, crop))) \
                == want

    # the generator stages
    assert [float(v) for v in re.findall(
        r"int\(s \* ([\d.]+)\)\s+for s in GSIZE", ROOT_BENCH)] == [
        bench.GEN_CFG["bank_scale"], bench.GEN_CFG["extent_scale"]]
    synth = [c for c in _in_order(run, ast.Call)
             if isinstance(c.func, ast.Name) and c.func.id == "SynthStatic"]
    assert len(synth) == 2
    kw = [{k.arg: k.value for k in c.keywords} for c in synth]
    for k in ("all_samples", "mild_samples"):
        assert ast.literal_eval(kw[0][k]) == bench.GEN_CFG[k]
        assert ast.literal_eval(kw[1][k]) == bench.GEN_CFG[k]
    pathol = {k: ast.literal_eval(v) for k, v in kw[1].items()
              if k not in ("size", "all_samples", "mild_samples")}
    assert pathol == {k: v for k, v in bench.PATHOL_CFG.items()
                      if k != "task"}
    assigns = {n.targets[0].id: n.value for n in _in_order(run, ast.Assign)
               if isinstance(n.targets[0], ast.Name)}
    assert ast.literal_eval(assigns["tasks"]) == bench.GEN_CFG["tasks"]
    assert ast.literal_eval(assigns["ptasks"].right) == (
        bench.PATHOL_CFG["task"],)
    knobs = next(c for c in _in_order(run, ast.Call)
                 if isinstance(c.func, ast.Name)
                 and c.func.id == "build_knobs_stack")
    assert ast.literal_eval(knobs.args[1]) == bench.GEN_CFG["input_mode"]


def test_roofline_counts_every_convolution_of_a_unet():
    """2 * k^3 * Cin * Cout per output voxel of every Conv3d of UNet3D
    (f_maps 8, 3 levels, 32^3); the bench's smoke model (the fused heads
    too) counts the same on the meta device as on the CPU."""
    torch.manual_seed(0)
    model = UNet3D(f_maps=8, num_levels=3)
    want = []

    def hook(mod, inp, out):
        k = math.prod(mod.kernel_size)
        voxels = out.numel() // out.shape[1]
        want.append(2 * k * mod.in_channels * mod.out_channels * voxels)

    for m in model.modules():
        if isinstance(m, torch.nn.Conv3d):
            m.register_forward_hook(hook)
    total, ops = roofline.forward_flops(model, torch.randn(1, 1, 32, 32, 32))
    assert len(want) == 10   # 2 in each of 3 encoders and 2 decoders
    assert total == sum(want)
    assert ops == {"aten.convolution": total}

    shape = bench.SHAPES["smoke"]
    cfg = bench.model_cfg(bench.INFER_CFG, shape, shape["win"])
    counts = []
    for dev in ("cpu", "meta"):
        _, joint = build_model(cfg, device=dev)
        counts.append(roofline.forward_flops(
            joint, torch.zeros((1, 24, 24, 24, 1), device=dev))[0])
    assert counts[0] == counts[1] > 0


def test_profile_infer_times_every_stage():
    """The stage split at the bench's smoke shapes on the CPU, one timed
    call a stage: the private hooks of models/ and infer/ it reaches
    (`_encode`, `_head_out`, `_model_input`, `Inferencer._post` and
    `_forward`) still answer."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)   # as the smoke's child: beside other workers
    try:
        recs = list(profile_infer.profile(bench.SHAPES["smoke"],
                                          torch.device("cpu"), reps=1))
    finally:
        torch.set_num_threads(threads)
    assert [r["stage"] for r in recs] == [
        "encoders", "backbone", "heads", "postprocess", "forward"]
    for r in recs:
        assert 0 < r["ms_min"] <= r["ms"] <= r["ms_max"], r
        assert r["calls"] == 2 and r["size"] == 48
