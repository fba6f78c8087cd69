"""Build, load and launch the hand-written CUDA kernels of csrc/.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` for sm_90a into its own shared library, at first use, into
`_build/` (git-ignored), keyed by a hash of the source and the flags; it
is loaded with ctypes. `build()` starts one nvcc per source at once.
Nothing here runs at import time.

Every launch goes through `launch`, which raises when the C function
returns a CUDA error and adds one to that kernel's count in `LAUNCHES`,
so a run can show which kernels its path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# per-source extra flags: the warp blend must round exactly like the plain
# PyTorch version, so no multiply-add contraction there
EXTRA_FLAGS = {"warp": ("-fmad=false",)}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C function -> (source, argtypes)
FUNCTIONS = {
    "warp_linear_f32": ("warp", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL,
                                 _LL, _LL, _P]),
    "warp_nearest_i32": ("warp", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _P]),
    "lut_gather_f32": ("lut", [_P, _P, _P, _I, _I, _LL, _P]),
    "lut_gather_i32": ("lut", [_P, _P, _P, _I, _I, _LL, _P]),
}
SOURCES = sorted({src for src, _ in FUNCTIONS.values()})

LAUNCHES = {fn: 0 for fn in FUNCTIONS}
_LIBS: dict = {}
# serving prepares the next volume on a host thread while the calling
# thread serves the current one: the first use of a library from either
# builds and loads it once, and no launch count is lost
_LIBS_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def reset_launches():
    for fn in LAUNCHES:
        LAUNCHES[fn] = 0


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    """Where the library of csrc/<name>.cu lives for its current source."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile every missing library, one nvcc process per source, all
    started together. Returns {name: {"seconds": s, "ptxas": log}}; a
    library already built reports 0 seconds and an empty log."""
    names = SOURCES if names is None else names
    BUILD_DIR.mkdir(exist_ok=True)
    procs, out = {}, {}
    t0 = time.perf_counter()
    for name in names:
        dst = library_path(name)
        if dst.exists():
            out[name] = {"seconds": 0.0, "ptxas": ""}
            continue
        tmp = dst.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, dst)
    failed = []
    for name, (proc, tmp, dst) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, dst)  # atomic: a concurrent build sees all or none
        out[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def _library(name: str):
    with _LIBS_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            for fn, (src, argtypes) in FUNCTIONS.items():
                if src == name:
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def launch(fn: str, *args):
    """Call C function `fn` of its library on PyTorch's current stream
    (appended as the last argument); raise on a CUDA error."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(_library(FUNCTIONS[fn][0]), fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc} at launch")
    with _COUNT_LOCK:
        LAUNCHES[fn] += 1
