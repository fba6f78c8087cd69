"""What the benchmark's modules may import and read, walked with `ast`."""

from __future__ import annotations

import ast
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "brainfm_tpu"}
# the measurements of the JAX package on a TPU that the benchmark reads none
# of: the root bench.py, BASELINE.json, BENCH_*.json, MULTICHIP_*.json
HISTORY = re.compile(r"(^|/)(bench\.py|BASELINE\.json|BENCH_\w*\.json|"
                     r"MULTICHIP_\w*\.json)$")


def modules():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    """Top-level names of every import in `path`, with the level of a
    relative one resolved against the brainbench package."""
    tree = ast.parse(open(path).read(), path)
    rel = os.path.relpath(path, os.path.dirname(BENCH)).split(os.sep)[:-1]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = rel[:len(rel) - node.level + 1]
                yield ".".join(base + ([node.module] if node.module else []))
            else:
                yield node.module


def test_every_module_parses():
    assert len(list(modules())) > 20


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_and_no_jax_package(path):
    tops = {m.split(".")[0] for m in imported(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    p for p in modules() if os.sep + "reference" + os.sep in p),
    ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_port(path):
    tops = {m.split(".")[0] for m in imported(path)}
    assert "brainfm_tpu_torch" not in tops
    inner = {m for m in imported(path) if m.startswith("brainbench.")}
    assert all(m.startswith("brainbench.reference") for m in inner), inner


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reads_none_of_the_tpu_measurements(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert not HISTORY.search(node.value.strip()), node.value
