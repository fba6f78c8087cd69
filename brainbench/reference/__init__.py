"""The benchmark's plain reference: plain PyTorch and NumPy that imports
nothing of brainfm_tpu_torch and takes nothing the program made.

`model.py` is written from the layer equations (UNet3D, UNet3D-Sep, the
task heads, the processors and postprocessing). The rest are frozen copies
of the port's plain code, whose own docstrings still name the modules they
were ported from: the generator (`synth/`, with `ops/lut.py` and
`ops/warp.py` replaced by the plain versions the port's kernels are held
to), `criterion.py` and `losses.py`, `schedules.py`, `prepare.py` with the
zoom of `ops/resize.py`, and NIfTI reading (`utils/`). Frozen means a later
change to the program does not change them: the benchmark holds the
program to what they compute.
"""
