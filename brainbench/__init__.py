"""The benchmark of brainfm_tpu_torch on one H100: `python3 -m
brainbench.run` (run.py) runs one cell of BENCHMARK.json; the cells'
configurations, traffic mixes, limits and per-layer metrics are files here
found by name (cells.py); `reference/` is the plain reference the outputs
are checked against; `control.py` takes the readings the limits are set
from; `tests/` runs on the CPU."""
