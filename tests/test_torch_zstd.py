"""The port's zstd decoder (``native/zstd.c`` through
``native.zstd_decompress``) against the ``zstandard`` library: frames of
levels 1, 3, 19 and 22, sizes 0 to 1 MiB, random float32, zeros, repetitive
text, with and without a content checksum or size, several frames and a
skippable frame back to back; every truncated frame, and every corrupted
one that zstandard refuses, raising ValueError."""

import os

import numpy as np
import pytest
import zstandard

from styletransfer_tpu_torch import native

LEVELS = [1, 3, 19, 22]
SIZES = [0, 1, 1024, 128 * 1024 + 1, 1 << 20]


def _data(kind, size):
    if kind == "f32":
        return np.random.default_rng(size).standard_normal(size // 4 + 1).astype(
            np.float32).tobytes()[:size]
    if kind == "zeros":
        return bytes(size)
    text = b"the quick brown fox jumps over the lazy dog, then naps; " * (size // 40 + 1)
    return text[:size]


def _frame(data, level, checksum=True, content_size=True):
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=content_size).compress(data)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("kind", ["f32", "zeros", "text"])
def test_decodes_what_zstandard_encodes(kind, level, size):
    data = _data(kind, size)
    for checksum in (False, True):
        assert native.zstd_decompress(_frame(data, level, checksum)) == data


@pytest.mark.parametrize("level", LEVELS)
def test_frames_without_a_content_size(level):
    data = _data("text", 300_000) + _data("f32", 200_000)
    assert native.zstd_decompress(_frame(data, level, content_size=False)) == data


def test_blocks_flushed_one_by_one_reuse_tables():
    """A streamed frame: many small compressed blocks, whose later ones
    repeat the earlier ones' Huffman and FSE tables."""
    data = _data("text", 200_000) + _data("f32", 100_000)
    c = zstandard.ZstdCompressor(level=5, write_checksum=True).compressobj()
    frame = b"".join(c.compress(data[i:i + 5000]) + c.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)
                     for i in range(0, len(data), 5000)) + c.flush()
    assert native.zstd_decompress(frame) == data


def test_several_frames_and_a_skippable_frame_back_to_back():
    parts = [_data("f32", 70_000), _data("zeros", 5000), b"", _data("text", 150_000)]
    frames = [_frame(p, level, checksum=i % 2 == 0)
              for i, (p, level) in enumerate(zip(parts, LEVELS))]
    skippable = (0x184D2A5E).to_bytes(4, "little") + (7).to_bytes(4, "little") + b"comment"
    stream = frames[0] + skippable + b"".join(frames[1:]) + skippable
    assert native.zstd_decompress(stream) == b"".join(parts)


def test_a_long_window():
    """Level 22 on 3 MiB with a repeat 2 MiB back: matches beyond 1 MiB."""
    block = _data("f32", 1 << 20)
    data = block + _data("text", 1 << 20) + block
    frame = zstandard.ZstdCompressor(level=22, write_checksum=True).compress(data)
    assert len(frame) < 2.5 * (1 << 20)
    assert native.zstd_decompress(frame) == data


@pytest.mark.parametrize("kind", ["f32", "text"])
def test_every_truncation_raises(kind):
    frame = _frame(_data(kind, 20_000), 3)
    for cut in sorted(set(np.linspace(0, len(frame) - 1, 60).astype(int))):
        with pytest.raises(ValueError, match="zstd: "):
            native.zstd_decompress(frame[:cut])


@pytest.mark.parametrize("kind", ["f32", "text", "zeros"])
def test_corrupted_frames_raise(kind):
    """Seeded bit flips in the blocks of a checksummed frame: every frame
    that zstandard refuses is refused (by a structural check or by the
    checksum), and none decodes to other bytes than zstandard's. A flip can
    leave the content as it was (a one-byte raw literal turned into a
    one-byte RLE literal of the same value); such a frame decodes to it."""
    frame = _frame(_data(kind, 60_000), 19)
    rng = np.random.default_rng(7)
    refused = 0
    for pos in rng.integers(zstandard.frame_header_size(frame), len(frame), 80):
        bad = bytearray(frame)
        bad[pos] ^= 1 << int(rng.integers(0, 8))
        try:
            want = zstandard.ZstdDecompressor().decompress(bytes(bad))
        except zstandard.ZstdError:
            refused += 1
            with pytest.raises(ValueError, match="zstd: "):
                native.zstd_decompress(bytes(bad))
        else:
            assert native.zstd_decompress(bytes(bad)) == want == _data(kind, 60_000)
    assert refused >= 70


@pytest.mark.parametrize("case,message", [
    ("magic", "bad magic"),
    ("reserved_bit", "reserved bit"),
    ("checksum", "checksum mismatch"),
    ("block_type", "reserved block type"),
    ("trailing", "trailing bytes"),
    ("empty", "no zstd frame"),
])
def test_named_faults(case, message):
    frame = bytearray(_frame(_data("text", 5000), 3))
    if case == "magic":
        frame[0] ^= 0xFF
    elif case == "reserved_bit":
        frame[4] |= 0x08
    elif case == "checksum":
        frame[-1] ^= 0x01
    elif case == "block_type":
        frame[zstandard.frame_header_size(bytes(frame))] |= 0x06  # first block's type: 3
    elif case == "trailing":
        frame += b"\x00\x01"
    else:
        frame = bytearray()
    with pytest.raises(ValueError, match=message):
        native.zstd_decompress(bytes(frame))


def test_a_dictionary_frame_is_refused_by_its_id():
    samples = [_data("text", 300)[i:] + bytes([i]) for i in range(64)]
    d = zstandard.train_dictionary(2048, samples)
    frame = zstandard.ZstdCompressor(dict_data=d).compress(_data("text", 4000))
    with pytest.raises(ValueError, match=f"dictionary {d.dict_id()}"):
        native.zstd_decompress(frame)


def test_without_a_compiler_it_raises_naming_the_compilers(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_zstd_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "native"))
    empty = tmp_path / "empty_path"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    with pytest.raises(RuntimeError, match=r"no C compiler \(cc, gcc, clang\).*zstd\.c"):
        native.zstd_decompress(_frame(b"abc", 1))
    assert not os.path.exists(tmp_path / "native") or os.listdir(tmp_path / "native") == []
