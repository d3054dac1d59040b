"""The torch port's encode of linked frames and big blocks held against the
JAX package on the CPU.

Frames from divortio_lz4_tpu_torch.compress_frame must be byte-identical to
the JAX device_compress_frame(engine="split") at every block size (64 KB,
256 KB, 1 MB, 4 MB) in both block modes, with a dictionary, block
checksums and a content checksum, and decode back on the port. The
segment stage (a 64 KB block is one segment) is compared piece by piece
first: segment rows, the meta serializer's (stream, meta) per segment,
then the spliced frames, including the splicer's end-of-segment rules.
Tolerance: exact everywhere.
"""

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

import divortio_lz4_tpu as lz4
import divortio_lz4_tpu_torch as pt
from _torch_port import cuda, mixed_payload, one_torch_thread  # noqa: F401
from divortio_lz4_tpu.config import FrameConfig
from divortio_lz4_tpu.ops import hybrid_encode as jax_hybrid
from divortio_lz4_tpu.ops import split_encode as jax_split
from divortio_lz4_tpu.parallel import bigblock as jax_bb
from divortio_lz4_tpu.parallel.device import (device_compress_frame,
                                              device_decompress_frame)
from divortio_lz4_tpu_torch import tracing
from divortio_lz4_tpu_torch.ops import split_encode as pt_split
from divortio_lz4_tpu_torch.parallel import bigblock as pt_bb

SIZES = {"64k": 65536, "256k": 262144, "1m": 1048576, "4m": 4194304}


def _data_and_dict(n=300_000, seed=21):
    data = mixed_payload(n, seed)
    return data, np.array(data[20_000:50_000])


def _check_frame(data, cfg, dic=None):
    want = np.asarray(device_compress_frame(data, cfg, dictionary=dic,
                                            engine="split"))
    got = pt.compress_frame(data, cfg, dictionary=dic, device="cpu")
    assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(
        pt.decompress_frame(got, dictionary=dic, device="cpu"), data)
    np.testing.assert_array_equal(
        np.asarray(lz4.decompress(got, dictionary=dic)), data)
    return got


@pytest.mark.parametrize("mode", ["linked", "independent"])
@pytest.mark.parametrize("size", list(SIZES))
def test_frames_match_jax(size, mode):
    """Each size and mode twice: plain with a content checksum, then with
    a dictionary and block checksums."""
    data, d = _data_and_dict()
    cfg = FrameConfig(block_size=SIZES[size],
                      block_independence=mode == "independent",
                      content_checksum=True)
    _check_frame(data, cfg)
    _check_frame(data, cfg.with_(block_checksums=True), d)


def test_default_config_matches_jax():
    """FrameConfig() is the reference's default: 4 MB linked blocks."""
    data, _ = _data_and_dict(n=120_000, seed=22)
    frame = _check_frame(data, FrameConfig())
    assert frame.tobytes() == np.asarray(device_compress_frame(
        data, engine="split")).tobytes()


@pytest.mark.parametrize("with_dict", [False, True],
                         ids=["no_dict", "dict"])
@pytest.mark.parametrize("linked", [False, True],
                         ids=["independent", "linked"])
@pytest.mark.parametrize("bs", [65536, 262144], ids=["64k", "256k"])
def test_segment_stage_matches_jax(bs, linked, with_dict):
    """Rows, chains and the meta serializer's per-row (stream, meta) equal
    the JAX segment stage's before any splicing, at 64 KB (one segment a
    block) and 256 KB. Where the port leaves out the history columns
    (independent 64 KB blocks without a dictionary), JAX's rows have none
    valid and their payload columns are the port's rows."""
    data, d = _data_and_dict(n=200_000, seed=23)
    window = d[-65536:] if with_dict else None
    rows = pt_bb.history_rows(data, bs, pt_bb.SEG, window, linked)
    ref_work, ref_lens, ref_start, ref_blocks = jax_bb._segment_rows(
        data, bs, window, linked)
    np.testing.assert_array_equal(rows.lens, ref_lens)
    if rows.hist_len == 0:
        assert bs == 65536 and not linked and window is None
        np.testing.assert_array_equal(rows.work, ref_work[:, 65536:])
        np.testing.assert_array_equal(ref_start, 65536)
        np.testing.assert_array_equal(rows.hist_start, 0)
    else:
        np.testing.assert_array_equal(rows.work, ref_work)
        np.testing.assert_array_equal(rows.hist_start, ref_start)
    per = bs // pt_bb.SEG
    assert [list(range(k, min(k + per, len(rows.lens))))
            for k in range(0, len(rows.lens), per)] == ref_blocks
    chains = pt_split.encode_blocks_chain(
        rows.work, rows.lens, pt_bb.SEG, rows.hist_len, rows.hist_start,
        device="cpu").numpy()
    np.testing.assert_array_equal(chains, np.asarray(
        jax_hybrid.build_dist_chains(rows.work.astype(np.int32), rows.lens,
                                     rows.hist_len, rows.hist_start)))
    streams, metas = pt_bb.serialize_rows(rows, chains)
    if rows.hist_len:
        outs, out_lens, want_metas = jax_bb._encode_segments(
            ref_work, ref_lens, ref_start)
        want = [outs[k, :n] for k, n in enumerate(out_lens)]
    else:
        # JAX's segment stage always builds its chains over 64 KB of
        # history; rows without one are its small-block split rows, which
        # its meta serializer encodes from its chains (== the port's)
        got = [jax_split.chain_select_serialize_meta(
            np.append(rows.work[k], np.zeros(8, np.uint8)), 0,
            int(rows.lens[k]), chains[k]) for k in range(len(rows.lens))]
        want = [w for w, _ in got]
        want_metas = np.stack([m for _, m in got])
    assert len(streams) == len(want)
    for got_s, want_s in zip(streams, want):
        np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(metas, want_metas)
    wk = np.zeros(rows.work.shape[1] + 8, np.uint8)
    wk[:-8] = rows.work[1]
    s, meta = pt_split.chain_select_serialize_meta(
        wk, rows.hist_len, int(rows.lens[1]), chains[1])
    s_ref, meta_ref = jax_split.chain_select_serialize_meta(
        wk, rows.hist_len, int(rows.lens[1]), chains[1])
    np.testing.assert_array_equal(s, s_ref)
    np.testing.assert_array_equal(meta, meta_ref)


def _splice_corpus(kind):
    rng = np.random.default_rng(24)
    if kind == "runs_across_segments":
        # RLE runs over segment ends: the final match of a segment is
        # re-extended into the next and may swallow whole segments
        return np.concatenate([np.full(150_000, 7, np.uint8),
                               rng.integers(0, 256, 1_000, np.uint8),
                               np.full(140_000, 9, np.uint8)])
    if kind == "literal_segments":
        # all-literal segments between compressible ones, ending short of
        # MF_LIMIT
        return np.concatenate([mixed_payload(70_000, 25),
                               rng.integers(0, 256, 140_000, np.uint8),
                               mixed_payload(66_000, 26)])
    if kind == "single_short_block":
        return mixed_payload(50_000, 27)
    assert kind == "tail_of_12"
    return np.concatenate([mixed_payload(65_536, 28),
                           np.full(12, 5, np.uint8)])


@pytest.mark.parametrize("kind", ["runs_across_segments", "literal_segments",
                                  "single_short_block", "tail_of_12"])
def test_splice_edge_cases_match_jax(kind):
    data = _splice_corpus(kind)
    for linked in (False, True):
        _check_frame(data, FrameConfig(block_size=262144,
                                       block_independence=not linked))


def _planted(seed, start, dist, length, n=40_000):
    """Random bytes in which plaintext at *start* repeats itself at -dist
    for exactly *length* bytes (byte by byte, so dist < length overlaps),
    then differs."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, n, np.uint8)
    for i in range(length):
        raw[start + i] = raw[start - dist + i]
    if start + length < n:
        raw[start + length] = raw[start - dist + length] ^ 0x5A
    return raw


def _ext_case(case):
    """(raw, start, dist, limit) of one _ext_len case."""
    kind, _, arg = case.partition(":")
    if kind == "limit":                      # 0 and negative limits
        return _planted(30, 1000, 100, 500), 1000, 100, int(arg)
    if kind == "mismatch":                   # first mismatch at offset arg
        return _planted(31, 30_000, 3000, int(arg), 70_000), 30_000, \
            3000, 39_000
    if kind == "run512":                     # matches all the way to limit
        run = np.random.default_rng(32).integers(0, 256, 512, np.uint8)
        raw = np.tile(run, 200)
        return raw, 70_000, 512, len(raw) - 5 - 70_000
    if kind == "zeros":
        raw = np.zeros(300_000, np.uint8)
        return raw, 65_536, 1, len(raw) - 5 - 65_536
    if kind == "overlap":                    # dist < length: self-overlap
        dist, length = (int(x) for x in arg.split("/"))
        return _planted(33, 5000, dist, length), 5000, dist, 20_000
    if kind == "midwindow":                  # limit ends inside a window
        limit, length = (int(x) for x in arg.split("/"))
        return _planted(34, 8000, 700, length), 8000, 700, limit
    if kind == "past_end":                   # limit beyond the buffer
        return _planted(35, 39_000, 400, 1000), 39_000, 400, 5000
    assert kind == "random"
    rng = np.random.default_rng(int(arg))
    dist = int(rng.integers(1, 65_536))
    length = int(rng.integers(0, 3000))
    start = int(rng.integers(dist, 100_000))
    return (_planted(int(arg), start, dist, length, 110_000), start, dist,
            int(rng.integers(1, 110_000 - start)))


EXT_CASES = (["limit:0", "limit:-5", "mismatch:0"]
             + ["mismatch:%d" % (e + d) for e in (64, 320, 1344, 5440, 21824)
                for d in (-1, 0, 1)]
             + ["run512", "zeros", "overlap:1/3000", "overlap:3/900",
                "overlap:100/5000", "midwindow:200/300",
                "midwindow:1000/999", "midwindow:1000/400", "past_end"]
             + ["random:%d" % k for k in range(40, 48)])


@pytest.mark.parametrize("case", EXT_CASES)
def test_ext_len_matches_full_scan(case):
    """The boundary extension's windowed compare returns what the JAX
    module's full scan of the rest of the block returns."""
    raw, start, dist, limit = _ext_case(case)
    assert pt_bb._ext_len(raw, start, dist, limit) \
        == jax_bb._ext_len(raw, start, dist, limit)


def test_default_frame_splice_compares_what_it_extends(monkeypatch,
                                                       one_torch_thread):
    """An 8 MiB FrameConfig() frame (4 MB linked blocks) equals the JAX
    frame, and the splice compares at most 4x each extension it finds plus
    one 64-byte window a boundary; beyond the extensions found, under 1% of
    the plaintext. (The payload's JSON half repeats every 1000 records, so
    one extension genuinely runs to its block's end.)"""
    data = mixed_payload((8 << 20) + 12_345, 31)
    found = []
    ext_len = pt_bb._ext_len

    def logged(*args):
        found.append(ext_len(*args))
        return found[-1]

    monkeypatch.setattr(pt_bb, "_ext_len", logged)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = pt.compress_frame(data, pt.FrameConfig(), device="cpu")
    compared = tracing.counters()["compress_frames"]["splice_cmp_bytes"]
    tracing.reset()
    assert got.tobytes() == np.asarray(
        device_compress_frame(data, engine="split")).tobytes()
    assert len(found) > 40
    assert sum(found) <= compared <= 4 * sum(found) + 64 * len(found)
    assert compared - sum(found) < len(data) // 100


@pytest.mark.parametrize("payload", [b"", b"Hello World", b"ab" * 40000],
                         ids=["empty", "hello", "rle"])
def test_small_payloads_match_jax(payload):
    for size in ("64k", "1m"):
        for linked in (False, True):
            cfg = FrameConfig(block_size=SIZES[size],
                              block_independence=not linked)
            want = np.asarray(device_compress_frame(payload, cfg,
                                                    engine="split"))
            got = pt.compress_frame(payload, cfg, device="cpu")
            assert got.tobytes() == want.tobytes()
            assert pt.decompress_frame(got, device="cpu").tobytes() \
                == payload


def test_frames_in_flight_match_single_frames():
    """compress_frames queues every frame's chains before one fetch; each
    frame equals its single-frame encode, whatever its size."""
    data, d = _data_and_dict(n=260_000, seed=29)
    datas = [data[:90_000], data[90_000:], b"", data[:1000]]
    for cfg in (FrameConfig(block_size=262144, block_independence=True),
                FrameConfig(block_size=65536)):
        frames = pt.compress_frames(datas, cfg, dictionary=d, device="cpu")
        for f, x in zip(frames, datas):
            assert f.tobytes() == pt.compress_frame(
                x, cfg, dictionary=d, device="cpu").tobytes()
            assert pt.decompress_frame(f, dictionary=d,
                                       device="cpu").tobytes() == bytes(x)
    ref = np.asarray(device_decompress_frame(frames[1], dictionary=d,
                                             engine="split"))
    np.testing.assert_array_equal(ref, datas[1])


@pytest.mark.cuda
def test_cuda_big_frames_match_cpu(cuda):
    data, d = _data_and_dict()
    for size in ("64k", "256k", "4m"):
        for indep in (False, True):
            cfg = FrameConfig(block_size=SIZES[size],
                              block_independence=indep,
                              content_checksum=True)
            want = pt.compress_frame(data, cfg, dictionary=d, device="cpu")
            got = pt.compress_frame(data, cfg, dictionary=d, device=cuda)
            assert got.tobytes() == want.tobytes()
            out = pt.decompress_frame(got, dictionary=d, device=cuda)
            np.testing.assert_array_equal(out, data)
