"""The torch port's encode of linked frames and big blocks held against the
JAX package on the CPU.

Frames from divortio_lz4_tpu_torch.compress_frame must be byte-identical to
the JAX device_compress_frame(engine="split") at every block size (64 KB,
256 KB, 1 MB, 4 MB) in both block modes, with a dictionary, block
checksums and a content checksum, and decode back on the port. The big-
block segment stage is compared piece by piece first: segment rows, the
meta serializer's (stream, meta) per segment, then the spliced frames,
including the splicer's end-of-segment rules. Tolerance: exact everywhere.
"""

import numpy as np
import pytest

import divortio_lz4_tpu as lz4
import divortio_lz4_tpu_torch as pt
from _torch_port import cuda, mixed_payload  # noqa: F401  (cuda: fixture)
from divortio_lz4_tpu.config import FrameConfig
from divortio_lz4_tpu.ops import hybrid_encode as jax_hybrid
from divortio_lz4_tpu.ops import split_encode as jax_split
from divortio_lz4_tpu.parallel import bigblock as jax_bb
from divortio_lz4_tpu.parallel.device import (device_compress_frame,
                                              device_decompress_frame)
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


@pytest.mark.parametrize("linked", [False, True],
                         ids=["independent", "linked"])
def test_segment_stage_matches_jax(linked):
    """Segment rows, chains and the meta serializer's per-segment (stream,
    meta) equal the JAX stage's before any splicing."""
    data, d = _data_and_dict(n=200_000, seed=23)
    window = d[-65536:]
    rows = pt_bb._segment_rows(data, 262144, window, linked)
    ref = jax_bb._segment_rows(data, 262144, window, linked)
    for a, b in zip(rows[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)
    assert rows[3] == ref[3]
    work, lens, hist_start, _ = ref
    chains = pt_split.encode_blocks_chain(work, lens, pt_bb.SEG, 65536,
                                          hist_start, device="cpu").numpy()
    np.testing.assert_array_equal(chains, np.asarray(
        jax_hybrid.build_dist_chains(work.astype(np.int32), lens, 65536,
                                     hist_start)))
    outs, out_lens, metas = pt_bb._encode_segments(work, lens, chains)
    want = jax_bb._encode_segments(work, lens, hist_start)
    np.testing.assert_array_equal(out_lens, want[1])
    np.testing.assert_array_equal(metas, want[2])
    np.testing.assert_array_equal(outs, want[0])
    wk = np.zeros(work.shape[1] + 8, np.uint8)
    wk[:-8] = work[1]
    s, meta = pt_split.chain_select_serialize_meta(wk, 65536, int(lens[1]),
                                                   chains[1])
    s_ref, meta_ref = jax_split.chain_select_serialize_meta(
        wk, 65536, int(lens[1]), chains[1])
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
