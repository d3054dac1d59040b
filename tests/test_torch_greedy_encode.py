"""The torch port's greedy encoder (engine="pallas") held against the JAX
package on the CPU.

The port's plain encode_blocks_pallas must equal the JAX
encode_blocks_pallas (its Pallas kernel in interpret mode) row for row,
out_len included; compress_frame(engine="pallas") must equal the JAX
device_compress_frame(engine="pallas") and the host encoder
divortio_lz4_tpu.compress byte for byte. Linked frames and dictionaries
go to the XLA encoder, as JAX sends them, with JAX's bytes. Tolerance: exact
bytes everywhere; each row is compared over [0, out_len), where the TPU
kernel leaves wild writes past it and the port zeros.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divortio_lz4_tpu as lz4
import divortio_lz4_tpu_torch as pt
from _torch_port import cuda, mixed_payload  # noqa: F401  (cuda: fixture)
from _torch_port import one_torch_thread  # noqa: F401  (fixture)
from divortio_lz4_tpu.config import FrameConfig
from divortio_lz4_tpu.ops import pallas_encode as jax_pe
from divortio_lz4_tpu.parallel.device import device_compress_frame
from divortio_lz4_tpu_torch.ops import greedy_encode as pt_ge
from divortio_lz4_tpu_torch.parallel import device as pt_device
from test_pallas_encode import CASES

KB = 1024


def _rows(seed: int):
    """tests/test_pallas_encode.py's cases, then an empty row, a row
    shorter than MF_LIMIT, an RLE row and a random row."""
    rng = np.random.default_rng(seed)
    return [CASES[k] for k in sorted(CASES)] + [
        np.zeros(0, np.uint8), np.frombuffer(b"abcabcabca", np.uint8),
        np.full(9000, 0x41, np.uint8),
        rng.integers(0, 256, 6000, dtype=np.uint8)]


def _batch(rows, B):
    work = np.zeros((len(rows), B), np.uint8)
    lens = np.zeros(len(rows), np.int64)
    for i, r in enumerate(rows):
        r = r[:B]
        work[i, : len(r)] = r
        lens[i] = len(r)
    return work, lens


@pytest.mark.parametrize("B", [4 * KB, 16 * KB])
def test_plain_encode_matches_jax_kernel(B):
    work, lens = _batch(_rows(B), B)
    out, out_lens = pt_ge.encode_blocks_pallas(torch.from_numpy(work),
                                               torch.from_numpy(lens), B)
    jo, jl = jax_pe.encode_blocks_pallas(
        jnp.asarray(work.astype(np.int32)),
        jnp.asarray(lens.astype(np.int32)), B, True)
    jo, jl = np.asarray(jo), np.asarray(jl)
    assert out.shape == (len(work), pt_ge.out_width(B))
    np.testing.assert_array_equal(out_lens.numpy(), jl)
    for i, n in enumerate(jl):
        np.testing.assert_array_equal(out[i, :n].numpy(), jo[i, :n],
                                      err_msg=f"row {i}")
        assert not out[i, n:].any()
    # the reference encoder's bytes, row by row
    for i, n in enumerate(jl):
        if lens[i]:
            want = np.asarray(lz4.compress_raw(work[i, : lens[i]]))
            np.testing.assert_array_equal(out[i, :n].numpy(), want)


def _far_row(n: int, at: int, seed: int) -> np.ndarray:
    """*n* bytes, zeros but for two 8 KB chunks of random bytes, each
    written twice: chunk A at 0 and 65535 (a match at the largest offset),
    chunk B at *at* and at + 65536, where every candidate lies one byte
    past the window and the window check must refuse it."""
    rng = np.random.default_rng(seed)
    row = np.zeros(n, np.uint8)
    for start, gap in ((0, 65535), (at, 65536)):
        chunk = rng.integers(1, 256, 8192, dtype=np.uint8)
        row[start: start + 8192] = chunk
        row[start + gap: start + gap + 8192] = chunk
    return row


@pytest.mark.parametrize("level", ["blocks", "frame"])
def test_window_check_in_256k_blocks(level):
    """Repeats 65535 and 65536 bytes back, in 256 KB blocks: the port's
    bytes equal the host encoder's (and, for the frame, JAX's)."""
    rows = [_far_row(200_000, 80_000, 1), _far_row(256 * KB, 150_000, 2)]
    if level == "blocks":
        work, lens = _batch(rows, 256 * KB)
        out, out_lens = pt_ge.encode_blocks_pallas(
            torch.from_numpy(work), torch.from_numpy(lens), 256 * KB)
        for i, r in enumerate(rows):
            want = np.asarray(lz4.compress_raw(r))
            assert int(out_lens[i]) == len(want), f"row {i}"
            np.testing.assert_array_equal(out[i, : len(want)].numpy(), want)
        return
    cfg = FrameConfig(block_size=256 * KB, block_independence=True,
                      content_checksum=True)
    data = rows[0]
    got = pt.compress_frame(data, cfg, engine="pallas", device="cpu")
    assert got.tobytes() == np.asarray(lz4.compress(data,
                                                    config=cfg)).tobytes()
    want = np.asarray(device_compress_frame(data, cfg, engine="pallas"))
    assert got.tobytes() == want.tobytes()


# Two little-endian words with one hash (hash 0 of the 14-bit table).
_SAME_HASH = (0xDE257AB6, 0x9B6E60A3)


def _hostile(case: str):
    """(rows, block size) for the kernel's batched probes: hash conflicts
    inside one warp step, a hit on lane 31, miss runs whose step has grown
    past 1, batches cut by mf_limit, the u16 table's edge, the int32
    table's window, and the plain cases."""
    rng = np.random.default_rng(len(case))
    r = rng.integers(0, 256, 4 * KB, dtype=np.uint8)
    if case == "batch_hash_equal_words":
        r[9:13] = r[2:6]                  # lane 9's candidate is lane 2
        return [r], 4 * KB
    if case == "batch_hash_unequal_words":
        a, b = (np.frombuffer(np.uint32(x).tobytes(), np.uint8)
                for x in _SAME_HASH)
        r[2:6], r[9:13], r[40:44] = a, b, a     # lane 9 writes the table
        r2 = rng.integers(0, 256, 4 * KB, dtype=np.uint8)
        r2[2:6], r2[9:13], r2[16:20] = a, b, a  # lane 16's candidate: 9
        return [r, r2], 4 * KB
    if case == "hit_on_lane_31":
        # s = 0 misses; the step from s = 1 probes 1 + i on lane i, so
        # position 32 is lane 31. The 48-byte row ends the scan after it.
        r[32:36] = r[0:4]
        return [r[:48].copy(), r], 4 * KB
    if case == "grown_step":
        r = rng.integers(0, 256, 16 * KB, dtype=np.uint8)
        r[12000:14000] = r[100:2100]
        return [r, rng.integers(0, 256, 16 * KB, dtype=np.uint8)], 16 * KB
    if case == "cut_by_mf_limit":
        rows = []
        for n in (13, 17, 40, 45, 50, 60, 77):
            x = rng.integers(0, 256, n, dtype=np.uint8)
            if n >= 20:                   # a hit in the cut step
                x[n - 15: n - 11] = x[1:5]
            rows.append(x)
        return rows, KB
    if case == "u16_edge_64k":
        r = rng.integers(0, 256, 64 * KB, dtype=np.uint8)
        r[65000:] = r[: 64 * KB - 65000]          # source at position 0
        return [r, np.zeros(64 * KB, np.uint8)], 64 * KB
    if case == "window_256k":
        return [_far_row(200_000, 80_000, 1)], 256 * KB
    return _rows(4), 4 * KB


HOSTILE = ["batch_hash_equal_words", "batch_hash_unequal_words",
           "hit_on_lane_31", "grown_step", "cut_by_mf_limit", "u16_edge_64k",
           "window_256k", "zero_short_empty_random"]


@pytest.mark.parametrize("case", HOSTILE)
def test_batched_rendition_matches_plain_and_jax(case):
    """encode_blocks_pallas_batched_plain (the kernel's 32-probe steps)
    equals the plain scan, the host encoder and, on rows of at most 16 KB,
    the JAX kernel in interpret mode."""
    rows, B = _hostile(case)
    work, lens = _batch(rows, B)
    w, ln = torch.from_numpy(work), torch.from_numpy(lens)
    out, out_lens, stats = pt_ge.encode_blocks_pallas_batched_plain(w, ln, B)
    want = pt_ge.encode_blocks_pallas_plain(w, ln, B)
    assert torch.equal(out, want[0]) and torch.equal(out_lens, want[1])
    assert stats.shape == (len(rows), 2) and (stats[:, 1] <= stats[:, 0]).all()
    for i, n in enumerate(out_lens.tolist()):
        ref = np.asarray(lz4.compress_raw(work[i, : lens[i]])) if lens[i] \
            else np.zeros(0, np.uint8)
        np.testing.assert_array_equal(out[i, :n].numpy(), ref,
                                      err_msg=f"row {i}")
    if B <= 16 * KB:
        jo, jl = jax_pe.encode_blocks_pallas(
            jnp.asarray(work.astype(np.int32)),
            jnp.asarray(lens.astype(np.int32)), B, True)
        np.testing.assert_array_equal(out_lens.numpy(), np.asarray(jl))
        for i, n in enumerate(np.asarray(jl)):
            np.testing.assert_array_equal(out[i, :n].numpy(),
                                          np.asarray(jo)[i, :n])
    if case == "hit_on_lane_31":           # 32 literals, then the match
        for i in range(2):
            assert int(out[i, 0]) >> 4 == 15 and int(out[i, 1]) == 17
        # one probe at s = 0, then the batched step whose lane 31 hits
        assert stats[0].tolist() == [2, 1]


def _payload(seed: int) -> np.ndarray:
    """40 KB of JSON-like records, then 70 KB of random bytes: compressed
    and stored 64 KB blocks in one payload, few probes per block."""
    rng = np.random.default_rng(seed)
    return np.concatenate([mixed_payload(80_000, seed)[:40_000],
                           rng.integers(0, 256, 70_000, dtype=np.uint8)])


FRAMES = {
    "64k_content_checksum": FrameConfig(block_size=64 * KB,
                                        block_independence=True,
                                        content_checksum=True),
    "64k_block_checksums": FrameConfig(block_size=64 * KB,
                                       block_independence=True,
                                       block_checksums=True),
    "256k_content_checksum": FrameConfig(block_size=256 * KB,
                                         block_independence=True,
                                         content_checksum=True),
    "256k_block_checksums": FrameConfig(block_size=256 * KB,
                                        block_independence=True,
                                        block_checksums=True,
                                        content_size=False),
}


@pytest.mark.parametrize("name", list(FRAMES))
def test_frames_match_jax_and_host_encoder(name):
    cfg = FRAMES[name]
    data = _payload(21)
    got = pt.compress_frame(data, cfg, engine="pallas", device="cpu")
    want = np.asarray(device_compress_frame(data, cfg, engine="pallas"))
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == np.asarray(lz4.compress(data,
                                                    config=cfg)).tobytes()
    np.testing.assert_array_equal(
        pt.decompress_frame(got, engine="pallas", device="cpu"), data)


def test_small_frames_match_host_encoder():
    cfg = FrameConfig(block_size=64 * KB, block_independence=True)
    frames = pt.compress_frames([b"", b"Hello World", b"xy" * 70_000], cfg,
                                engine="pallas", device="cpu")
    for f, x in zip(frames, [b"", b"Hello World", b"xy" * 70_000]):
        assert f.tobytes() == np.asarray(lz4.compress(x, config=cfg)) \
            .tobytes()


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("case", ["linked", "dictionary"])
def test_linked_and_dictionary_raise(case, monkeypatch):
    """Linked frames and dictionaries, which used to raise here, go to the
    XLA encoder as in JAX: JAX's bytes, and the greedy kernel is never
    called."""
    data = mixed_payload(10_000, 3)
    cfg = FrameConfig(block_size=64 * KB,
                      block_independence=case == "dictionary")
    d = data[:2000] if case == "dictionary" else None

    def greedy(*args, **kwargs):
        raise AssertionError("the greedy kernel ran")
    monkeypatch.setattr(pt_device, "encode_blocks_pallas", greedy)
    got = pt.compress_frame(data, cfg, dictionary=d, engine="pallas",
                            device="cpu")
    want = np.asarray(device_compress_frame(data, cfg, dictionary=d,
                                            engine="pallas"))
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == pt.compress_frame(
        data, cfg, dictionary=d, engine="xla", device="cpu").tobytes()


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda):
    rng = np.random.default_rng(4)
    batches = {
        64 * KB: _rows(4) + [mixed_payload(65536, s) for s in range(4)]
        + [rng.integers(0, 256, 65536, dtype=np.uint8)]
        + _hostile("u16_edge_64k")[0]
        + [x for c in HOSTILE[:5] for x in _hostile(c)[0]],
        # past 64 KB the window check decides: repeats 65535 and 65536 back
        256 * KB: [_far_row(256 * KB, 150_000, 5), mixed_payload(90_000, 6)],
        4 * 1024 * KB: [_far_row(4 * 1024 * KB, 3 * 1024 * KB, 7)],
    }
    for B, rows in batches.items():
        work, lens = _batch(rows, B)
        w, ln = torch.from_numpy(work), torch.from_numpy(lens)
        want = pt_ge.encode_blocks_pallas_plain(w, ln, B)
        before = pt_ge.encode_blocks_pallas.launches
        got = pt_ge.encode_blocks_pallas(w.to(cuda), ln.to(cuda), B)
        assert pt_ge.encode_blocks_pallas.launches == before + 1
        torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=0)
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=0)
        if B == 64 * KB:      # the warp steps and hits of the rendition
            torch.testing.assert_close(
                pt_ge.encode_blocks_pallas.last_stats.cpu(),
                pt_ge.encode_blocks_pallas_batched_plain(w, ln, B)[2],
                rtol=0, atol=0)
