"""The port's .nii.gz writer (brainfm_tpu_torch/utils/nifti.py): a volume
is deflated in chunks of whole z-planes on a thread pool and joined into
one gzip member at level 1, whose payload is byte for byte what the serial
writer wrote (a frozen copy below) and what the JAX package's `save_nifti`
writes. The chunk size is patched so that a 40x48x37 volume spans many
chunks with a partial last one.
"""

import gzip
import os
import struct
import zlib

import numpy as np
import pytest

from brainfm_tpu.utils import nifti as jnifti
from brainfm_tpu_torch.infer.api import Inferencer
from brainfm_tpu_torch.utils import nifti

SHAPE = (40, 48, 37)
PLANE = SHAPE[0] * SHAPE[1] * 4
CHUNK = 3 * PLANE           # three z-planes of float32: 13 chunks, the last 1
AFF = np.array([[0.0, -1.2, 0.1, 90.0], [1.0, 0.0, 0.0, -126.0],
                [0.0, 0.05, 1.5, -72.0], [0.0, 0.0, 0.0, 1.0]])


def _serial_file(arr, aff, clip):
    """The bytes the serial route wrote, frozen: `Inferencer._write_outputs`'
    clip at 0, `viewVolume`'s squeeze and float32 cast, `save_nifti`'s header
    and Fortran-order payload (decompressed)."""
    arr = np.clip(arr, 0.0, None) if clip else arr
    data = np.asarray(arr).squeeze().astype(np.float32)
    dim = np.zeros(8, np.int16)
    dim[0] = data.ndim
    dim[1:1 + data.ndim] = data.shape
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    hdr[40:56] = dim.tobytes()
    struct.pack_into("<h", hdr, 70, 16)
    struct.pack_into("<h", hdr, 72, 32)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<f", hdr, 112, 1.0)
    struct.pack_into("<f", hdr, 116, 0.0)
    pixdim = np.ones(8, np.float32)
    pixdim[1:4] = np.sqrt((aff[:3, :3] ** 2).sum(0))
    hdr[76:108] = pixdim.tobytes()
    struct.pack_into("<h", hdr, 252, 0)
    struct.pack_into("<h", hdr, 254, 1)
    hdr[280:328] = np.asarray(aff[:3, :], np.float32).tobytes()
    hdr[344:348] = b"n+1\x00"
    return bytes(hdr) + np.asarray(data, order="F").tobytes(order="F")


def _labels(rng):
    return rng.integers(-3, 60, SHAPE).astype(np.int32)


def _negatives(rng):
    return rng.standard_normal(SHAPE).astype(np.float32)


def _doubles(rng):
    """float64 whose float32 cast rounds, underflows to -0.0, or is NaN."""
    v = rng.standard_normal(SHAPE) / 3.0
    v[0, 0, :4] = [-0.0, -1e-50, np.nan, 1e40]
    return v


def _four_d(rng):
    return rng.standard_normal(SHAPE + (3,)).astype(np.float32)


# output key (clipped unless a registration coordinate) -> volume
CASES = {"labels": ("label", _labels), "float": ("T1", _negatives),
         "regx": ("regx", _negatives), "float64": ("T2", _doubles),
         "four_d": ("dist", _four_d)}


def _write(tmp_path, key, arr, ext=".nii.gz"):
    """One output through `Inferencer._write_outputs` (which uses no state
    of its Inferencer); the written file's path."""
    Inferencer._write_outputs(Inferencer.__new__(Inferencer),
                              {key: arr[None, ..., None]}, AFF,
                              str(tmp_path), ext)
    return os.path.join(tmp_path, f"out_{key}{ext}")


@pytest.mark.parametrize("chunks", ["one", "many"])
@pytest.mark.parametrize("case", CASES)
def test_same_bytes_as_the_serial_route(tmp_path, monkeypatch, case, chunks):
    if chunks == "many":
        monkeypatch.setattr(nifti, "CHUNK_BYTES", CHUNK)
    key, make = CASES[case]
    arr = make(np.random.default_rng(5))
    clip = key not in ("regx", "regy", "regz")
    with open(_write(tmp_path, key, arr), "rb") as f:
        got = gzip.decompress(f.read())
    want = _serial_file(arr, AFF, clip)
    assert got == want
    jax_path = str(tmp_path / "jax.nii.gz")
    jnifti.save_nifti(jax_path, (np.clip(arr, 0.0, None) if clip else arr)
                      .squeeze().astype(np.float32), AFF)
    with gzip.open(jax_path, "rb") as f:
        assert f.read() == want


@pytest.mark.parametrize("shape", [(0, 4, 3), (), (7,), (40, 48)],
                         ids=["empty", "scalar", "1d", "2d"])
def test_other_ranks_match_the_jax_writer(tmp_path, monkeypatch, shape):
    monkeypatch.setattr(nifti, "CHUNK_BYTES", 160)
    data = np.random.default_rng(1).standard_normal(shape)
    nifti.save_nifti(str(tmp_path / "t.nii.gz"), data, AFF)
    jnifti.save_nifti(str(tmp_path / "j.nii.gz"), data, AFF)
    with gzip.open(tmp_path / "t.nii.gz") as a, \
            gzip.open(tmp_path / "j.nii.gz") as b:
        assert a.read() == b.read()


def test_plain_nii_keeps_its_bytes(tmp_path):
    arr = _negatives(np.random.default_rng(2))
    with open(_write(tmp_path, "T1", arr, ext=".nii"), "rb") as f:
        assert f.read() == _serial_file(arr, AFF, True)


@pytest.mark.parametrize("chunks", ["one", "many"])
def test_one_gzip_member_at_level_one(tmp_path, monkeypatch, chunks):
    if chunks == "many":
        monkeypatch.setattr(nifti, "CHUNK_BYTES", CHUNK)
    levels, compressobj = [], zlib.compressobj

    def spy(level, *args, **kwargs):
        levels.append(level)
        return compressobj(level, *args, **kwargs)

    monkeypatch.setattr(zlib, "compressobj", spy)
    with open(_write(tmp_path, "label", _labels(np.random.default_rng(3))),
              "rb") as f:
        raw = f.read()
    assert levels == [1] * (13 if chunks == "many" else 1)
    assert raw[:4] == b"\x1f\x8b\x08\x00" and raw[8] == 4  # no name, fastest
    d = zlib.decompressobj(wbits=31)
    body = d.decompress(raw)
    assert d.eof and d.unused_data == b""
    assert len(body) == 352 + 4 * np.prod(SHAPE)


def test_the_file_does_not_depend_on_the_pool(tmp_path, monkeypatch):
    monkeypatch.setattr(nifti, "CHUNK_BYTES", CHUNK)
    arr = _labels(np.random.default_rng(4))
    files = []
    for threads in (1, 8):
        monkeypatch.setattr(nifti, "THREADS", threads)
        monkeypatch.setattr(nifti, "_pool", None)
        with open(_write(tmp_path / str(threads), "label", arr), "rb") as f:
            files.append(f.read())
    assert nifti._pool._max_workers == 8
    assert files[0] == files[1]


@pytest.mark.parametrize("byte", [-8, -5, -4, -1], ids=["crc0", "crc3",
                                                         "isize0", "isize3"])
def test_a_flipped_trailer_byte_is_caught(tmp_path, monkeypatch, byte):
    monkeypatch.setattr(nifti, "CHUNK_BYTES", CHUNK)
    with open(_write(tmp_path, "T1", _negatives(np.random.default_rng(6))),
              "rb") as f:
        raw = bytearray(f.read())
    gzip.decompress(bytes(raw))
    raw[byte] ^= 0x10
    with pytest.raises(gzip.BadGzipFile):
        gzip.decompress(bytes(raw))


@pytest.mark.parametrize("n1,n2", [(0, 0), (5, 0), (0, 9), (1, 1),
                                   (352 + 3, 32768), (1000, 1 << 20 | 3)])
def test_crc32_combine_equals_zlib(n1, n2):
    rng = np.random.default_rng(n1 + n2)
    a, b = rng.bytes(n1), rng.bytes(n2)
    assert nifti.crc32_combine(zlib.crc32(a), zlib.crc32(b), n2) == \
        zlib.crc32(a + b)
