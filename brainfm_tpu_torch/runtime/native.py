"""g++ builds of the port's host-side C++ libraries (volcodec.cpp,
zstd.cpp): each is compiled at first use into brainfm_tpu_torch/_build/
(git-ignored), keyed by a hash of its source and flags, for the generic
x86-64 target (no -march=native: a build may move to another host), and
loaded with ctypes by its binding. A failed build raises with the
compiler's output; no binding has a pure-Python stand-in."""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


def library_path(source: Path, flags: tuple) -> Path:
    """Where the library of `source` built with `flags` lives."""
    h = hashlib.sha256(Path(source).read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(source: Path, flags: tuple, libs: tuple,
          force: bool = False) -> Path:
    """Compile `source` unless its library exists (or always, with
    `force`); raise RuntimeError with g++'s output when the build fails."""
    name = Path(source).stem
    dst = library_path(source, flags + libs)
    if dst.exists() and not force:
        return dst
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = dst.with_suffix(f".tmp{os.getpid()}")
    cmd = ["g++", *flags, str(source), *libs, "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"{name} build: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{name} build failed ({' '.join(cmd)}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, dst)   # atomic: a concurrent build sees all or none
    return dst
