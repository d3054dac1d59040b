"""The plain reference decoder: the spec's golden vectors, frames of the
port's host codec for both configurations, and frames that break the
formats."""

import json
import os

import numpy as np
import pytest

from lz4bench import checks
from lz4bench.corpus import make_corpus
from lz4bench.reference.frame import decode_frame
from lz4bench.reference.xxh32 import xxh32

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The upstream golden.test.mjs vectors, as tests/test_golden.py quotes them.
GOLDEN_HELLO = "04224D186040820B00008048656c6c6f20576f726c6400000000"
GOLDEN_EMPTY_4MB = "04224D1860707300000000"
GOLDEN_HELLO_CK = ("04224D186440A70B00008048656c6c6f20576f726c6400000000"
                   "EE16FDB1")
_A_BLOCK = "1F410100" + "FF" * 256 + "E750" + "41" * 5
GOLDEN_MULTIBLOCK = "04224D18604082" + ("0B010000" + _A_BLOCK) * 2 \
    + "00000000"
_PAT = "4142434445464748494A4B4C4D4E4F50"
GOLDEN_LINKED_XBLOCK = (
    "04224D184040C0"
    + "1B010000" + "FF01" + _PAT + "1000" + "FF" * 256 + "D850"
    + "4C4D4E4F50"
    + "8A000000" + "0F1000" + "FF" * 128 + "6850" + "4C4D4E4F50"
    + "00000000")
GOLDEN_BLOCK_CK = ("04224D187040AD0B00008048656C6C6F20576F726C64EE16FDB1"
                   "00000000")
GOLDEN_MIXED_STORED = ("04224D18604082" + "0B010000" + _A_BLOCK
                       + "1B000080"
                       + b"incompressible tail bytes!!".hex().upper()
                       + "00000000")
GOLDEN_CONTENT_SIZE = ("04224D1868400B00000000000000580B00008048656C6C6F2057"
                       "6F726C6400000000")
GOLDEN = [
    (GOLDEN_HELLO, b"Hello World"),
    (GOLDEN_EMPTY_4MB, b""),
    (GOLDEN_HELLO_CK, b"Hello World"),
    (GOLDEN_MULTIBLOCK, b"A" * 131072),
    (GOLDEN_LINKED_XBLOCK, b"ABCDEFGHIJKLMNOP" * 6144),
    (GOLDEN_BLOCK_CK, b"Hello World"),
    (GOLDEN_MIXED_STORED, b"A" * 65536 + b"incompressible tail bytes!!"),
    (GOLDEN_CONTENT_SIZE, b"Hello World"),
]


def _config(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)["frame"]


def test_xxh32_spec_values():
    assert xxh32(b"") == 0x02CC5D05
    assert xxh32(b"Hello World") == 0xB1FD16EE


@pytest.mark.parametrize("hexframe,plain", GOLDEN)
def test_golden_vectors(hexframe, plain):
    out, fr = decode_frame(bytes.fromhex(hexframe))
    assert out.tobytes() == plain
    assert fr.faults == []


@pytest.fixture(scope="module")
def payloads():
    c = make_corpus(3, 1 << 20)
    return [c[:300_000], c[400_000:470_000], c[5000:6500], c[900_000:900_011],
            np.zeros(200_000, np.uint8),
            np.tile(np.arange(3, dtype=np.uint8), 40_000)]


@pytest.mark.parametrize("name", ["cli64k", "libdefault4m"])
@pytest.mark.parametrize("codec", ["host", "split"])
def test_port_frames_decode_exactly(payloads, name, codec):
    import divortio_lz4_tpu_torch as pt

    frame = _config(name)
    cfg = pt.FrameConfig(**frame)
    for data in payloads:
        f = pt.compress(data, config=cfg) if codec == "host" else \
            pt.compress_frame(data, cfg, engine="split", device="cpu")
        out, fr = decode_frame(np.asarray(f).tobytes())
        assert out.tobytes() == data.tobytes()
        assert fr.faults == [] and checks.stated_faults(fr, frame) == []


def _frame(data, **kw):
    import divortio_lz4_tpu_torch as pt

    return bytearray(pt.compress(data, config=pt.FrameConfig(**kw))
                     .tobytes())


def _fix_hc(f):
    """Rewrite the header checksum of an edited descriptor (no content
    size, no dictionary)."""
    f[6] = (xxh32(bytes(f[4:6])) >> 8) & 0xFF
    return f


def test_linked_blocks_under_an_independent_flag_are_caught(payloads):
    f = _frame(payloads[0], block_size=65536, block_independence=False,
               content_size=False)
    f[4] |= 0x20
    _, fr = decode_frame(bytes(_fix_hc(f)))
    assert "a match reaches before its block" in fr.faults


@pytest.mark.parametrize("at,fault", [(-1, "content checksum"),
                                      (6, "header checksum")])
def test_broken_checksums_are_caught(payloads, at, fault):
    f = _frame(payloads[1], block_size=65536, block_independence=True,
               content_checksum=True, content_size=False)
    f[at] ^= 0x01
    _, fr = decode_frame(bytes(f))
    assert fault in fr.faults


def test_an_altered_token_is_caught(payloads):
    f = _frame(payloads[0], block_size=65536, block_independence=True,
               content_checksum=False, content_size=False)
    f[11] ^= 0x40          # the first block's first token
    out, fr = decode_frame(bytes(f))
    assert fr.faults or out.tobytes() != payloads[0].tobytes()


def test_end_rules_are_checked():
    # one sequence whose match runs to the block's end: lit 1, match 4
    # at offset 1, no last literals
    block = bytes([0x10, 0x41, 0x01, 0x00])
    f = bytearray.fromhex("04224D18604082") \
        + len(block).to_bytes(4, "little") + block + bytes(4)
    out, fr = decode_frame(bytes(f))
    assert "a block ends with a match" in fr.faults
    # a match inside the last 12 bytes, then 5 literals
    block = bytes([0x10, 0x41, 0x01, 0x00, 0x50]) + b"BBBBB"
    f = bytearray.fromhex("04224D18604082") \
        + len(block).to_bytes(4, "little") + block + bytes(4)
    out, fr = decode_frame(bytes(f))
    assert out.tobytes() == b"AAAAABBBBB"
    assert "a match starts within 12 bytes of its block's end" in fr.faults


def test_truncated_and_foreign_frames_are_unreadable(payloads):
    f = _frame(payloads[1])
    for bad in (bytes(f[:len(f) // 2]), b"\x00\x00\x00\x00rest"):
        out, fr = decode_frame(bad)
        assert out is None and fr.faults


def test_stated_settings_are_compared():
    from lz4bench.reference.frame import read_frame

    stated = _config("cli64k")
    f = _frame(np.zeros(1000, np.uint8), **dict(stated, content_size=True))
    assert checks.stated_faults(read_frame(bytes(f)), stated) == [
        "content size present or absent against the stated setting"]
