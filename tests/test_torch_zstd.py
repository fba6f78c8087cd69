"""The port's Zstandard decoder (brainfm_tpu_torch/runtime/zstd.cpp through
runtime/zstd.py) on the CPU: zarr chunks that tensorstore's zarr driver
compresses at zstd levels -5, 1, 3, 9 and 19 (the orbax checkpoints' own
writer), frames of the python-zstandard library (content checksums,
several frames, skippable frames, streamed frames without a content
size, random contents under hypothesis), hand-made frames with Raw and RLE
blocks, and the refusals: truncated, corrupt, dictionary and wrong-length
input. Decoding must be bitwise; XXH64 and CRC-32C hold their published
vectors."""

import numpy as np
import pytest
import tensorstore as ts
import xxhash
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from brainfm_tpu_torch.runtime import native, zstd

SIZES = (1, 131071, 131072, 131073, 3 << 20)
LEVELS = (-5, 1, 3, 9, 19)


def _contents(kind, n):
    rng = np.random.default_rng(n)
    if kind == "zeros":
        return bytes(n)
    if kind == "random":
        return rng.bytes(n)
    if kind == "low_entropy":   # int32 values in [0, 20): the bank's labels
        return rng.integers(0, 20, -(-n // 4)).astype(np.int32).tobytes()[:n]
    if kind == "float32":       # weights: Huffman-coded literals, few matches
        return (0.05 * rng.standard_normal(-(-n // 4))).astype(
            np.float32).tobytes()[:n]
    words = [rng.bytes(int(k)) for k in rng.integers(1, 40, 64)]
    out = b"".join(words[i] for i in rng.integers(0, 64, n // 10 + 1))
    return (out * 2)[:n]   # repeats near and far


def _tensorstore_chunk(tmp_path, data: bytes, level: int) -> bytes:
    """`data` as the one chunk of a zarr v2 uint8 array that tensorstore
    writes with the zstd compressor at `level`: the chunk's bytes."""
    path = tmp_path / f"z{level}_{len(data)}"
    arr = ts.open({"driver": "zarr",
                   "kvstore": {"driver": "file", "path": str(path)},
                   "metadata": {"dtype": "|u1", "shape": [len(data)],
                                "chunks": [len(data)],
                                "compressor": {"id": "zstd",
                                               "level": level}},
                   "create": True, "delete_existing": True,
                   "store_data_equal_to_fill_value": True}).result()
    arr[...] = np.frombuffer(data, np.uint8)
    return (path / "0").read_bytes()


@pytest.mark.parametrize("kind", ["zeros", "random", "low_entropy",
                                  "float32", "repeats"])
@pytest.mark.parametrize("level", LEVELS)
def test_tensorstore_zarr_chunks_decode_bitwise(tmp_path, level, kind):
    for n in SIZES:
        data = _contents(kind, n)
        frame = _tensorstore_chunk(tmp_path, data, level)
        assert zstd.decompress(frame, n) == data, (level, kind, n)


def test_batch_decodes_many_chunks_into_one_buffer(tmp_path, monkeypatch):
    """decode_batch: 64 frames on 32 threads (more than the cores), each
    at its aligned offset; a wrong expected size fails that item alone."""
    monkeypatch.setattr(zstd, "THREADS", 32)
    datas = [_contents(k, n) for k in ("zeros", "random", "low_entropy",
                                        "repeats")
             for n in (0, 1, 7, 1000, 131073, 400000, 17, 5)]
    datas = datas * 2
    frames = [zstandard.ZstdCompressor(level=1 + i % 5).compress(d)
              for i, d in enumerate(datas)]
    buf, offs = zstd.decode_batch(frames, [len(d) for d in datas])
    assert all(o % zstd.ALIGN == 0 for o in offs)
    for d, o in zip(datas, offs):
        assert buf[o:o + len(d)].tobytes() == d
    sizes = [len(d) for d in datas]
    sizes[9] += 1
    with pytest.raises(zstd.ZstdError, match="item 9") as e:
        zstd.decode_batch(frames, sizes)
    assert e.value.index == 9
    with pytest.raises(ValueError):
        zstd.decode_batch(frames, sizes[:-1])
    buf, offs = zstd.decode_batch([], [])
    assert buf.size == 0 and offs == []


@settings(max_examples=80, deadline=None)
@given(data=st.binary(max_size=50_000),
       level=st.sampled_from([-7, 1, 4, 12, 19]),
       checksum=st.booleans())
def test_random_contents_decode_bitwise(data, level, checksum):
    frame = zstandard.ZstdCompressor(level=level,
                                     write_checksum=checksum).compress(data)
    assert zstd.decompress(frame, len(data)) == data


@settings(max_examples=60, deadline=None)
@given(words=st.lists(st.binary(min_size=1, max_size=24), min_size=1,
                      max_size=30),
       picks=st.lists(st.integers(0, 29), max_size=3000),
       level=st.sampled_from([-1, 3, 19]))
def test_repetitive_contents_decode_bitwise(words, picks, level):
    """Many matches and repeat offsets: words drawn again and again."""
    data = b"".join(words[i % len(words)] for i in picks)
    frame = zstandard.ZstdCompressor(level=level).compress(data)
    assert zstd.decompress(frame, len(data)) == data


def test_frames_one_after_another_and_skippable():
    """Two frames and a skippable frame between them decode to the two
    contents joined; a frame streamed without a content size decodes."""
    a, b = _contents("repeats", 300000), _contents("low_entropy", 70000)
    skip = (0x184D2A5E).to_bytes(4, "little") + (6).to_bytes(4, "little")
    frames = (zstandard.ZstdCompressor(level=3).compress(a) + skip
              + b"\xff" * 6 + zstandard.ZstdCompressor(
                  level=9, write_checksum=True).compress(b))
    assert zstd.decompress(frames, len(a) + len(b)) == a + b
    cobj = zstandard.ZstdCompressor(level=5).compressobj()
    streamed = b"".join(cobj.compress(a[i:i + 9000])
                        for i in range(0, len(a), 9000)) + cobj.flush()
    assert zstd.decompress(streamed, len(a)) == a
    assert zstd.decompress(streamed) == a   # within a bound instead


def _raw_rle_frame():
    """A hand-made single-segment frame (content size 9): an RLE block of
    five 'x', then a last Raw block 'abcd'."""
    fhd = 0x20                                   # single segment, 1-byte size
    rle = (5 << 3) | (1 << 1)                    # RLE, 5 bytes, not last
    raw = (4 << 3) | (0 << 1) | 1                # Raw, 4 bytes, last
    return (zstd_magic() + bytes([fhd, 9]) + rle.to_bytes(3, "little")
            + b"x" + raw.to_bytes(3, "little") + b"abcd")


def zstd_magic():
    return (0xFD2FB528).to_bytes(4, "little")


def test_raw_and_rle_blocks():
    assert zstd.decompress(_raw_rle_frame(), 9) == b"xxxxxabcd"


def _compressed_frame(block: bytes, size: int) -> bytes:
    """A single-segment frame (4-byte content size) of one last
    Compressed block."""
    head = ((len(block) << 3) | (2 << 1) | 1).to_bytes(3, "little")
    return (zstd_magic() + bytes([0x20 | (2 << 6)])
            + size.to_bytes(4, "little") + head + block)


def _huffman_bits(symbols) -> bytes:
    """Symbols 0 and 1, one bit each, as a backward bitstream: the first
    symbol just below the end marker."""
    n = len(symbols)
    value = 1 << n
    for i, x in enumerate(symbols):
        value |= int(x) << (n - 1 - i)
    return value.to_bytes(n // 8 + 1, "little")


@pytest.mark.parametrize("streams", [1, 4])
def test_literals_from_direct_huffman_weights(streams):
    """Compressed literals whose tree is given by direct 4-bit weights
    (one weight, symbol 0's, 1; symbol 1's implied): 1 stream, or 4
    streams of 251, 251, 251 and 248 symbols with their jump table; no
    sequences."""
    n = 1000 if streams == 1 else 1001
    sym = np.random.default_rng(6).integers(0, 2, n).astype(np.uint8)
    tree = bytes([128, 0x10])
    if streams == 1:
        body = _huffman_bits(sym)
    else:
        seg = (n + 3) // 4
        parts = [_huffman_bits(sym[i * seg:(i + 1) * seg]) for i in range(4)]
        body = b"".join(len(q).to_bytes(2, "little") for q in parts[:3]) \
            + b"".join(parts)
    comp = len(tree) + len(body)
    header = (2 | ((0 if streams == 1 else 1) << 2) | (n << 4)
              | (comp << 14)).to_bytes(3, "little")
    frame = _compressed_frame(header + tree + body + b"\x00", n)
    assert zstd.decompress(frame, n) == sym.tobytes()


def test_rle_sequence_tables_and_many_sequences():
    """A block of 32768 sequences (the 3-byte count) with all three tables
    in RLE mode (literal length code 1, offset code 0: the repeat offset
    1, match length code 0: 3 bytes) and no stream bits: every raw
    literal (3-byte header, 20-bit size) comes out four times."""
    lit = np.random.default_rng(7).integers(0, 256, 32768).astype(np.uint8)
    n = 32768
    block = ((0 | (3 << 2) | (n << 4)).to_bytes(3, "little") + lit.tobytes()
             + bytes([255, 0, 1])          # 0x7F00 + 0 + (1 << 8) sequences
             + bytes([0x54, 1, 0, 0])      # LL, OF, ML: RLE; their symbols
             + b"\x01")                    # the stream: its end marker only
    out = zstd.decompress(_compressed_frame(block, 4 * n), 4 * n)
    assert out == np.repeat(lit, 4).tobytes()


def test_refusals_raise_with_the_byte_offset():
    data = _contents("repeats", 200000)
    frame = zstandard.ZstdCompressor(level=3,
                                     write_checksum=True).compress(data)
    for cut in list(range(0, 40)) + list(range(40, len(frame), 97)):
        with pytest.raises(ValueError, match="at byte"):
            zstd.decompress(frame[:cut], len(data))
    with pytest.raises(ValueError, match="expected length"):
        zstd.decompress(frame, len(data) + 1)
    with pytest.raises(ValueError, match="expected length"):
        zstd.decompress(frame, len(data) - 1)
    bad = bytearray(frame)
    bad[-1] ^= 0x40                              # the content checksum
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(bad), len(data))
    with pytest.raises(ValueError, match="corrupt"):
        zstd.decompress(b"\x00" * 16, 16)        # no magic number
    with pytest.raises(ValueError, match="corrupt"):
        zstd.decompress(frame + b"\x01\x02\x03\x04\x05", len(data))
    # a dictionary ID of 5 (flag 1: one byte) before the content size
    dict_frame = (zstd_magic() + bytes([0x21, 5, 4])
                  + ((4 << 3) | 1).to_bytes(3, "little") + b"abcd")
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(dict_frame, 4)
    reserved = bytearray(_raw_rle_frame())
    reserved[4] |= 0x08
    with pytest.raises(ValueError, match="corrupt input at byte 4"):
        zstd.decompress(bytes(reserved), 9)
    with pytest.raises(ValueError):
        zstd.decompress(b"", 0)


def test_corrupted_frames_never_decode_silently():
    """Random byte changes in a checksummed frame: each raises or (a
    change the format cannot see, in padding) decodes to the same
    bytes; none crashes."""
    rng = np.random.default_rng(3)
    data = _contents("low_entropy", 150000)
    frame = zstandard.ZstdCompressor(level=3,
                                     write_checksum=True).compress(data)
    for _ in range(300):
        bad = bytearray(frame)
        bad[int(rng.integers(0, len(bad)))] = int(rng.integers(0, 256))
        try:
            assert zstd.decompress(bytes(bad), len(data)) == data
        except ValueError:
            pass


def test_xxh64_and_crc32c_vectors():
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    rng = np.random.default_rng(4)
    for n in (1, 3, 4, 7, 8, 31, 32, 33, 100, 1000):
        b = rng.bytes(n)
        for seed in (0, 1, 2 ** 64 - 1):
            assert zstd.xxh64(b, seed) == xxhash.xxh64_intdigest(b, seed)
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(b"") == 0


def test_library_is_built_from_the_checkout_without_libzstd():
    """g++ builds runtime/zstd.cpp into _build/ (keyed by the source's
    hash), linking no zstd library; a failed build raises with g++'s
    output."""
    zstd.decompress(_raw_rle_frame(), 9)
    lib = zstd.library_path()
    assert lib.parent.name == "_build" and lib.exists()
    assert not any("zstd" in f for f in zstd.LIBS)
    assert "#include <zstd" not in zstd.SOURCE.read_text()


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "zstd.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(zstd, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="zstd build failed"):
        zstd.build()
