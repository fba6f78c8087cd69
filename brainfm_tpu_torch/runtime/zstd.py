"""ctypes binding of the port's Zstandard decoder (zstd.cpp, RFC 8878),
which reads the zstd frames of the JAX package's orbax checkpoints: the
zarr chunks (train/orbax_read.py) and the OCDBT manifests and b-tree nodes
(runtime/ocdbt.py).

The library is built with g++ at first use (runtime/native.py) and links
nothing but the C++ runtime. A zarr chunk decodes to the length its
array's metadata gives it: output that would be longer or comes out
shorter raises, as does malformed or truncated input, with the byte
offset where decoding stopped (an OCDBT node, whose frame need not state
its length, decodes within a bound). Nothing is
returned after a failure.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path

import numpy as np

from . import native

SOURCE = Path(__file__).resolve().parent / "zstd.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lpthread",)
STATUS_TEXT = {-1: "truncated input", -2: "corrupt input",
               -3: "a dictionary is required", -4: "content checksum mismatch",
               -5: "output length differs from the expected length"}
# decode_batch's thread pool: the cores, at most 16
THREADS = min(16, os.cpu_count() or 1)
# offsets of the chunks in decode_batch's buffer are multiples of this, so
# every chunk can be viewed as an array of any dtype
ALIGN = 64

_LIB = None
_LOCK = threading.Lock()
_P = ctypes.c_void_p
_U64 = ctypes.c_uint64


class ZstdError(ValueError):
    """A frame that does not decode: `index` of the item in its batch,
    `offset` the byte offset in that item's input."""

    def __init__(self, msg, index=0, offset=0):
        super().__init__(msg)
        self.index, self.offset = index, offset


def build(force: bool = False) -> Path:
    """Compile the decoder unless its library exists (or always, with
    `force`); raise with g++'s output when the build fails."""
    return native.build(SOURCE, CXX_FLAGS, LIBS, force)


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    return native.library_path(SOURCE, CXX_FLAGS + LIBS)


def _load():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.zstd_decode.argtypes = [_P, _U64, _P, _U64, ctypes.c_int,
                                        ctypes.POINTER(_U64),
                                        ctypes.POINTER(_U64)]
            lib.zstd_decode.restype = ctypes.c_int
            lib.zstd_decode_batch.argtypes = [
                ctypes.c_int64, _P, _P, _P, _P, ctypes.c_int, _P, _P]
            lib.zstd_decode_batch.restype = ctypes.c_int64
            lib.zstd_xxh64.argtypes = [_P, _U64, _U64]
            lib.zstd_xxh64.restype = _U64
            lib.zstd_crc32c.argtypes = [_P, _U64]
            lib.zstd_crc32c.restype = ctypes.c_uint32
            _LIB = lib
        return _LIB


def _ptr(buf) -> int:
    """Address of a bytes object or a C-contiguous numpy array."""
    if isinstance(buf, np.ndarray):
        return buf.ctypes.data
    return ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p).value or 0


def decompress(data: bytes, size: int | None = None,
               max_size: int = 1 << 31) -> bytes:
    """The zstd frames `data` decoded. With `size` they must decode to
    exactly `size` bytes; without, to at most `max_size` (a frame need not
    state its content size)."""
    data = bytes(data)
    cap = size if size is not None else min(max_size, 4 * len(data) + 4096)
    while True:
        out = np.empty(cap, np.uint8)
        n, off = _U64(0), _U64(0)
        r = _load().zstd_decode(_ptr(data), len(data), _ptr(out), cap,
                                int(size is not None), ctypes.byref(n),
                                ctypes.byref(off))
        if r == -5 and size is None and cap < max_size:
            cap = min(max_size, 4 * cap)   # it did not fit: a larger bound
            continue
        if r != 0:
            raise ZstdError(f"zstd: {STATUS_TEXT.get(r, r)} at byte "
                            f"{off.value}", 0, off.value)
        return out[:n.value].tobytes()


def decode_batch(frames, sizes):
    """Decode the zstd inputs `frames` (bytes each) into one preallocated
    uint8 buffer on a pool of THREADS threads. Item i must decode to
    exactly `sizes[i]` bytes. Returns (buffer, offsets): item i is
    buffer[offsets[i]:offsets[i] + sizes[i]], each offset a multiple of
    ALIGN. The first failing item raises ZstdError (its index and byte
    offset); no buffer is returned then."""
    frames = [bytes(f) for f in frames]
    sizes = [int(s) for s in sizes]
    if len(frames) != len(sizes):
        raise ValueError(f"{len(frames)} frames, {len(sizes)} sizes")
    offsets, total = [], 0
    for s in sizes:
        if s < 0:
            raise ValueError(f"negative output size {s}")
        offsets.append(total)
        total += -(-s // ALIGN) * ALIGN
    buf = np.empty(total, np.uint8)
    n = len(frames)
    if n == 0:
        return buf, offsets
    base = buf.ctypes.data
    srcs = np.array([_ptr(f) for f in frames], np.uint64)
    src_lens = np.array([len(f) for f in frames], np.uint64)
    dsts = np.array([base + o for o in offsets], np.uint64)
    dst_lens = np.array(sizes, np.uint64)
    status = np.zeros(n, np.int32)
    err = np.zeros(n, np.uint64)
    failed = _load().zstd_decode_batch(
        n, srcs.ctypes.data, src_lens.ctypes.data, dsts.ctypes.data,
        dst_lens.ctypes.data, THREADS, status.ctypes.data,
        err.ctypes.data)
    if failed:
        i = int(np.flatnonzero(status)[0])
        raise ZstdError(f"zstd: item {i}: {STATUS_TEXT.get(int(status[i]))} "
                        f"at byte {int(err[i])}", i, int(err[i]))
    return buf, offsets


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of `data` (the hash of zstd's content checksum)."""
    data = bytes(data)
    return int(_load().zstd_xxh64(_ptr(data), len(data), seed))


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of `data` (the OCDBT footer's checksum)."""
    data = bytes(data)
    return int(_load().zstd_crc32c(_ptr(data), len(data)))
