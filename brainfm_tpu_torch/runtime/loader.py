"""ctypes binding of the port's native volume codec (volcodec.cpp, its own
copy of the JAX package's): parallel NIfTI decode into a fixed-shape
float32 arena.

The library is built with g++ at first use (runtime/native.py). A failed
build raises with the compiler's output; there is no pure-Python stand-in
for a missing library. The Python reader (utils/nifti.py) decodes
only what the codec leaves to it by design: files that are not NIfTI
(.mgz), NIfTI files with frames beyond 3-D (kept whole, as the Python
ingest keeps them) and voxel types the codec does not convert.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from . import native

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "volcodec.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
LIBS = ("-lz", "-lpthread")
# decode_one's status codes (volcodec.cpp) that leave a file to the
# Python reader: -5 a voxel type the codec does not convert, -6 frames
# beyond 3-D
_STATUS_TO_PYTHON = frozenset({-5, -6})
_STATUS_TEXT = {-1: "unreadable", -2: "bad gzip stream",
                -3: "not a NIfTI-1 header", -4: "truncated voxel data"}

_LIB = None
_LOCK = threading.Lock()


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    return native.library_path(SOURCE, CXX_FLAGS + LIBS)


def build(force: bool = False) -> Path:
    """Compile the codec unless its library exists (or always, with
    `force`); raise with g++'s output when the build fails."""
    return native.build(SOURCE, CXX_FLAGS, LIBS, force)


def build_native(force: bool = False) -> bool:
    """Build the codec (again with `force`); False, with g++'s stderr
    printed, when the build fails. `VolCodec` itself raises instead."""
    try:
        build(force)
        return True
    except RuntimeError as e:
        print(e)
        return False


def native_available() -> bool:
    """Whether the codec's library builds and loads."""
    try:
        _load()
        return True
    except (RuntimeError, OSError) as e:
        print(e)
        return False


def _load():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.volcodec_init.argtypes = [ctypes.c_int]
            lib.volcodec_decode_batch_ex.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int64)]
            lib.volcodec_decode_batch_ex.restype = ctypes.c_int
            _LIB = lib
        return _LIB


class VolCodec:
    """Parallel NIfTI batch decoder into a fixed-shape float32 arena."""

    def __init__(self, bank_shape, n_threads: int = 8):
        self.bank_shape = tuple(int(s) for s in bank_shape)
        self.lib = _load()
        self.lib.volcodec_init(n_threads)

    def _native(self, paths, arena):
        """Decode `paths` into the rows of `arena`; returns (status, dims)
        per file."""
        n = len(paths)
        c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        status = (ctypes.c_int * n)()
        dims = np.zeros((n, 4), np.int64)
        self.lib.volcodec_decode_batch_ex(
            c_paths, n, arena.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            *self.bank_shape, status,
            dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return list(status), dims

    @staticmethod
    def _raise(paths, status):
        bad = [(p, s, _STATUS_TEXT.get(s, "unknown"))
               for p, s in zip(paths, status)
               if s != 0 and s not in _STATUS_TO_PYTHON]
        if bad:
            raise IOError(f"volcodec decode failures: {bad}")

    def decode_batch(self, paths) -> np.ndarray:
        """Decode the NIfTI files `paths` into (N, *bank_shape) float32,
        zero padded; raises on any file the codec cannot decode."""
        paths = [str(p) for p in paths]
        arena = np.zeros((len(paths), *self.bank_shape), np.float32)
        if not paths:
            return arena
        status, _ = self._native(paths, arena)
        if any(status):
            raise IOError("volcodec decode failures: "
                          f"{[(p, s) for p, s in zip(paths, status) if s]}")
        return arena

    def decode_batch_with_shapes(self, paths):
        """Batch-decode `paths` into (N, *bank_shape) float32 plus each
        file's native 3-D extent. Returns (arena, shapes, extras): extras
        maps a row to the whole array of a file with frames beyond 3-D
        (its arena row is unused). .nii / .nii.gz files go through the
        codec; the rest, and the codec's multi-frame and voxel-type
        refusals, through the Python reader. Any other failure raises."""
        from ..utils.nifti import load_nifti

        paths = [str(p) for p in paths]
        n = len(paths)
        arena = np.zeros((n, *self.bank_shape), np.float32)
        shapes: list = [None] * n
        extras: dict = {}
        nii = [i for i, p in enumerate(paths)
               if p.endswith((".nii", ".nii.gz"))]
        python = sorted(set(range(n)) - set(nii))
        if nii:
            # decode straight into the arena when every file is NIfTI (the
            # common case): a staging buffer would hold a second copy
            sub = arena if len(nii) == n else \
                np.zeros((len(nii), *self.bank_shape), np.float32)
            status, dims = self._native([paths[i] for i in nii], sub)
            self._raise([paths[i] for i in nii], status)
            for j, i in enumerate(nii):
                if status[j] == 0:
                    if sub is not arena:
                        arena[i] = sub[j]
                    shapes[i] = tuple(int(d) for d in dims[j, :3])
                else:
                    python.append(i)
            del sub
        for i in sorted(python):
            vol = np.asarray(load_nifti(paths[i])[0], np.float32)
            # trailing singleton frames are a 3-D volume, as the codec
            # reads a file whose frames multiply to 1
            while vol.ndim > 3 and vol.shape[-1] == 1:
                vol = vol[..., 0]
            shapes[i] = tuple(int(s) for s in vol.shape[:3])
            if vol.ndim > 3:
                extras[i] = vol
                continue
            # the codec may have written part of this row before refusing
            arena[i].fill(0)
            sl = tuple(slice(0, min(a, b))
                       for a, b in zip(vol.shape[:3], self.bank_shape))
            arena[i][sl] = vol[sl]
        return arena, shapes, extras
