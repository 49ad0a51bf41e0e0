"""The port's zstd decoder (a3t_tpu_torch/native/zstd_decode.cc through
compat/zstd.py) against the frames that tensorstore writes for zarr v2
chunks with ``{"id": "zstd", "level": L}``, the compressor of every orbax
array: each chunk file's raw bytes decode to the array's bytes exactly, at
levels 1 to 22, over zeros (RLE blocks), random bytes (raw blocks and
literals), repetitive text, bf16 weight-like data, 1-byte arrays, arrays
just over a 128 KiB block, and a seeded sweep of sizes and mixtures.  The
content checksum (XXH64), which tensorstore does not write, is held on
frames built from tensorstore's by hand, and on zstandard's; malformed
frames raise ValueError."""

import json
import os
import struct

import numpy as np
import pytest
import tensorstore as ts

from a3t_tpu_torch.compat import zstd

LEVELS = (1, 3, 9, 19, 22)


def ts_frame(tmp_path, data: bytes, level: int, name="a",
             dtype="|u1") -> bytes:
    """The chunk file that tensorstore writes for ``data`` as a
    single-chunk zarr v2 array."""
    itemsize = 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize
    n = len(data) // itemsize
    path = str(tmp_path / f"{name}_{level}")
    spec = {"driver": "zarr", "kvstore": {"driver": "file", "path": path},
            "metadata": {"shape": [n], "chunks": [n], "dtype": dtype,
                         "compressor": {"id": "zstd", "level": level},
                         "order": "C", "filters": None}}
    arr = ts.open(spec, create=True, delete_existing=True).result()
    if dtype == "bfloat16":
        import ml_dtypes

        arr[...] = np.frombuffer(data, np.uint16).view(ml_dtypes.bfloat16)
    else:
        arr[...] = np.frombuffer(data, np.dtype(dtype))
    with open(os.path.join(path, ".zarray")) as f:
        assert json.load(f)["compressor"] == {"id": "zstd", "level": level}
    with open(os.path.join(path, "0"), "rb") as f:
        return f.read()


def _text(n):
    words = b"".join(b"param.block_%d.conv_module.kernel " % (i % 37)
                     for i in range(n // 20 + 1))
    return words[:n]


def _bf16(rng, n):
    x = (rng.standard_normal(n) * 0.05).astype(np.float32).view(np.uint32)
    return ((x + 0x7FFF + ((x >> 16) & 1)) >> 16).astype(np.uint16).tobytes()


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "zeros": bytes(300_000),
        "random": rng.bytes(200_000),
        "text": _text(250_000),
        "one_byte": b"\x07",
        "over_block": rng.bytes(131_073),
        "over_block_text": _text(131_075),
    }


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", sorted(_inputs()))
def test_tensorstore_frames(tmp_path, name, level):
    data = _inputs()[name]
    frame = ts_frame(tmp_path, data, level, name)
    assert frame[:4] == b"\x28\xb5\x2f\xfd"
    assert zstd.decompress(frame, len(data)) == data


@pytest.mark.parametrize("level", LEVELS)
def test_bf16_weights(tmp_path, level):
    """bfloat16 weight-like data, the stashes' arrays: Huffman-coded
    literals with few matches."""
    data = _bf16(np.random.default_rng(level), 150_000)
    frame = ts_frame(tmp_path, data, level, dtype="bfloat16")
    assert zstd.decompress(frame, len(data)) == data


def test_seeded_sweep_of_sizes_and_mixtures(tmp_path):
    """Random lengths (1 B to 600 KB) of concatenated runs, random bytes,
    text and bf16 data, at random levels; the sizes come from the frames
    too when they state them, and the bounded decode finds them."""
    rng = np.random.default_rng(7)
    makers = [lambda n: bytes([int(rng.integers(256))]) * n,
              lambda n: rng.bytes(n), _text,
              lambda n: _bf16(rng, n // 2 + 1)[:n]]
    for case in range(36):
        total = int(rng.integers(1, 600_000)) if case % 3 else int(
            rng.integers(1, 2_000))
        parts, size = [], 0
        while size < total:
            n = min(int(rng.integers(1, 70_000)), total - size)
            parts.append(makers[int(rng.integers(len(makers)))](n))
            size += n
        data = b"".join(parts)
        level = int(rng.choice([1, 2, 3, 5, 9, 12, 16, 19, 22]))
        frame = ts_frame(tmp_path, data, level, f"s{case}")
        assert zstd.decompress(frame, len(data)) == data, (case, level)
        stated = zstd.content_size(frame)
        assert stated in (None, len(data))
        # without the size: the bounded decode grows its buffer to it
        assert zstd.decompress_bounded(frame, 1 << 22) == data
        if len(data) > 1:
            with pytest.raises(ValueError, match="larger"):
                zstd.decompress_bounded(frame, len(data) - 1)


def _with_checksum(frame: bytes, data: bytes) -> bytes:
    """tensorstore's frame with the checksum flag set and the low 32 bits
    of XXH64(data) appended."""
    assert frame[4] & 4 == 0
    return (frame[:4] + bytes([frame[4] | 4]) + frame[5:]
            + struct.pack("<I", zstd.xxh64(data) & 0xFFFFFFFF))


def test_xxh64_and_checksummed_frames(tmp_path):
    # the reference vectors of XXH64 (seed 0)
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"abc") == 0x44BC2CF5AD770999
    import zstandard

    rng = np.random.default_rng(3)
    for data in (rng.bytes(5), _text(40_000), _bf16(rng, 90_000),
                 rng.bytes(200_001)):
        frame = _with_checksum(ts_frame(tmp_path, data, 3), data)
        assert zstd.decompress(frame, len(data)) == data
        bad = frame[:-1] + bytes([frame[-1] ^ 0x10])
        with pytest.raises(ValueError, match="checksum"):
            zstd.decompress(bad, len(data))
        # zstandard's checksummed frames (content size stated)
        zf = zstandard.ZstdCompressor(level=5, write_checksum=True).compress(
            data)
        assert zstd.decompress(zf) == data


def test_empty_and_skippable_frames():
    import zstandard

    empty = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(
        b"")
    assert zstd.decompress(empty, 0) == b""
    assert zstd.content_size(empty) == 0
    skip = struct.pack("<II", 0x184D2A5A, 3) + b"xyz"
    one = zstandard.ZstdCompressor(level=1).compress(b"hello")
    assert zstd.decompress(skip + one + skip + one, 10) == b"hellohello"


def test_malformed_frames_raise(tmp_path):
    """Truncated, bit-flipped and bad-magic frames raise ValueError; a
    flipped bit of a checksummed frame never yields other bytes."""
    rng = np.random.default_rng(11)
    data = _text(20_000) + _bf16(rng, 20_000) + bytes(5_000)
    frame = _with_checksum(ts_frame(tmp_path, data, 3), data)
    n = len(data)
    with pytest.raises(ValueError, match="magic"):
        zstd.decompress(b"\x00" + frame[1:], n)
    with pytest.raises(ValueError):
        zstd.decompress(b"", n)
    for cut in (1, 4, 5, 6, 9, len(frame) // 2, len(frame) - 5,
                len(frame) - 1):
        with pytest.raises(ValueError):
            zstd.decompress(frame[:cut], n)
    with pytest.raises(ValueError):  # output larger than the given size
        zstd.decompress(frame, n - 1)
    raised = 0
    for pos in rng.integers(0, len(frame), 400):
        bit = 1 << int(rng.integers(8))
        bad = bytearray(frame)
        bad[pos] ^= bit
        try:
            out = zstd.decompress(bytes(bad), n)
        except ValueError:
            raised += 1
            continue
        assert out == data, (pos, bit)  # a flip the format ignores
    assert raised > 350
    # a frame naming a dictionary is refused
    dict_frame = frame[:4] + bytes([frame[4] | 1]) + frame[5:6] + b"\x05" + \
        frame[6:]
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(dict_frame, n)
