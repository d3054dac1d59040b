"""The compact route's native staging
(``ops/split_decode.stage_compact_batch``) held against its reference,
``parse_wire_raw`` + ``build_flat_records``.

The arrays must be byte-identical on frames of the benchmark's cli64k
shape (64 KB independent blocks, a stored block, a short last block), with
a dictionary window and on one block, on 1 and 3 host threads (3 threads
give uneven ranges of blocks); the frames round-trip through
``decompress_frame`` on the CPU. Malformed blocks raise the reference's
"LZ4: ..." ValueError, the lowest-indexed bad block's where several are
bad.
"""

import functools

import numpy as np
import pytest

import divortio_lz4_tpu_torch as pt
from _torch_port import one_torch_thread  # noqa: F401  (fixture)
from divortio_lz4_tpu_torch.ops.split_decode import (build_flat_records,
                                                     parse_wire_raw,
                                                     stage_compact_batch)
from divortio_lz4_tpu_torch.parallel.device import parse_block_index
from lz4bench.corpus import make_corpus, segment_kinds

BS = 65536
CFG = pt.FrameConfig(block_size=BS, block_independence=True,
                     content_checksum=True)


@functools.lru_cache(maxsize=None)
def _case(kind):
    """(payload, frame, dictionary) of one case."""
    # 16 MiB of the corpus has 64 KB segments: one block a segment
    corpus = make_corpus(2147483918, 16 << 20)
    rnd = next(i for i, k in enumerate(segment_kinds())
               if k == "random" and i >= 3)
    dictionary = None
    if kind == "corpus":
        # three blocks, the random segment (a stored block), two more and
        # a short last block: 7 blocks
        data = corpus[(rnd - 3) * BS: (rnd + 3) * BS + 12345]
    elif kind == "dict":
        dictionary = corpus[: 40000].copy()
        data = np.concatenate([corpus[: 3 * BS], corpus[20000: 30000]])
    else:
        data = corpus[5 * BS: 5 * BS + 50000]
    frame = np.frombuffer(pt.compress(data.tobytes(), dictionary=dictionary,
                                      config=CFG), np.uint8)
    return data, frame, dictionary


@pytest.mark.parametrize("threads", ["1", "3"])
@pytest.mark.parametrize("kind", ["corpus", "dict", "one_block"])
def test_stage_compact_matches_reference(kind, threads, monkeypatch,
                                         one_torch_thread):
    monkeypatch.setenv("LZ4T_THREADS", threads)
    data, frame, window = _case(kind)
    _, blocks, _ = parse_block_index(frame)
    stored = sum(st for _, _, st in blocks)
    assert (len(blocks), stored) == {"corpus": (7, 1), "dict": (4, 0),
                                     "one_block": (1, 0)}[kind]
    wire, recs_l, _, out_lens, hist = parse_wire_raw(
        [(frame[o: o + s], st) for o, s, st in blocks], BS, window)
    words, rec_off = build_flat_records(recs_l)
    got = stage_compact_batch(frame, blocks, BS, window)
    if window is not None:      # the blocks' matches reach into it
        with pytest.raises(ValueError, match="Dictionary Offset"):
            stage_compact_batch(frame, blocks, BS)
    for a, b in zip(got, (wire, words, rec_off, out_lens, hist)):
        if b is None:
            assert a is None
        else:
            assert (a.dtype, a.shape) == (b.dtype, b.shape)
            np.testing.assert_array_equal(a, b)
    out = pt.decompress_frame(frame, dictionary=window, device="cpu")
    np.testing.assert_array_equal(out, data)


def _ok_block():
    return np.frombuffer(pt.compress_raw(bytes(range(256)) * 40), np.uint8)


# One malformed block each: a literal length run cut off by the block's
# end, offset 0, an offset before the block (no dictionary), and a match
# that writes past block_max.
FAULTS = {
    "truncated_run": np.array([0xF0, 0xFF, 0xFF], np.uint8),
    "offset0": np.frombuffer(b"\x10a\x00\x00\x50abcde", np.uint8),
    "offset_past_dict": np.frombuffer(b"\x10a\x05\x00\x50abcde", np.uint8),
    "past_block_max": np.frombuffer(
        pt.compress_raw(bytes(BS + 1000)), np.uint8),
}


def _raised(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def _both_raise(comps):
    """The reference's error text and stage_compact_batch's on *comps*."""
    entries = [(c, False) for c in comps]
    sizes = np.array([len(c) for c in comps], np.int64)
    blocks = np.stack([np.concatenate([[0], np.cumsum(sizes)[:-1]]), sizes,
                       np.zeros_like(sizes)], 1)
    buf = np.concatenate(comps)
    want = _raised(lambda: parse_wire_raw(entries, BS))
    got = _raised(lambda: stage_compact_batch(buf, blocks, BS))
    return want, got


@pytest.mark.parametrize("threads", ["1", "3"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_stage_compact_raises_the_reference_error(fault, threads,
                                                  monkeypatch):
    monkeypatch.setenv("LZ4T_THREADS", threads)
    ok = _ok_block()
    want, got = _both_raise([ok, ok, ok, FAULTS[fault], ok])
    assert want.startswith("LZ4: ")
    assert got == want


@pytest.mark.parametrize("threads", ["1", "3"])
@pytest.mark.parametrize("first,second", [("offset0", "truncated_run"),
                                          ("past_block_max",
                                           "offset_past_dict")])
def test_stage_compact_lowest_bad_block_wins(first, second, threads,
                                             monkeypatch):
    monkeypatch.setenv("LZ4T_THREADS", threads)
    ok = _ok_block()
    one = _both_raise([ok, FAULTS[first], ok])[0]
    want, got = _both_raise([ok, FAULTS[first], ok, ok, FAULTS[second], ok])
    assert got == want == one
    assert _both_raise([FAULTS[second]])[0] != one
