"""The torch port's engine="xla" (and engine="hybrid") decode held against
the JAX package on the CPU.

The port's decode_blocks_batch / decode_block_host (ops/decode_xla),
concat_blocks (ops/assemble_xla) and decode_linked_scan (ops/linked_xla)
must equal the JAX functions of the same names on the same numpy inputs,
out_len and the zero tail included, also on hostile random blocks, which
the XLA decoder clips instead of diagnosing; decompress_frame with
engine="xla" and "hybrid" must equal the JAX device_decompress_frame with
the same engine on frames from every encoder, and raise the same
"LZ4: ..." errors. Tolerance: 0, byte for byte everywhere.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divortio_lz4_tpu as lz4
import divortio_lz4_tpu_torch as pt
from _torch_port import cuda, mixed_payload  # noqa: F401  (cuda: fixture)
from _torch_port import one_torch_thread  # noqa: F401  (fixture)
from conftest import make_compressible
from divortio_lz4_tpu.config import FrameConfig
from divortio_lz4_tpu.ops import assemble_xla as jax_as
from divortio_lz4_tpu.ops import decode_xla as jax_dec
from divortio_lz4_tpu.ops import linked_xla as jax_lk
from divortio_lz4_tpu.parallel.device import device_decompress_frame
from divortio_lz4_tpu_torch.ops import assemble_xla as pt_as
from divortio_lz4_tpu_torch.ops import decode_xla as pt_dec
from divortio_lz4_tpu_torch.ops import encode_xla as pt_enc
from divortio_lz4_tpu_torch.ops import linked_xla as pt_lk
from divortio_lz4_tpu_torch.parallel.device import (_dict_window,
                                                    parse_block_index)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KB = 1024
W = 65536
B = 64 * KB
M = 64 * KB     # the compressed row width (_bucket_pow2 of the blocks)


def _streams(seed):
    """Block streams from the port's encoders (XLA with and without
    fingerprints, pallas, split), an empty stream's row, and their
    plaintexts."""
    rng = np.random.default_rng(seed)
    plains = [make_compressible(B), mixed_payload(B, seed),
              rng.integers(0, 4, 30_000, dtype=np.uint8),
              np.zeros(B, np.uint8)]
    streams = []
    for i, p in enumerate(plains):
        cfg = pt.FrameConfig(block_size=B, block_independence=True)
        engine = ("xla", "pallas", "split", "xla")[i]
        frame = pt.compress_frame(p, cfg, engine=engine, device="cpu",
                                  use_fingerprints=i != 3)
        _, blocks, _ = parse_block_index(frame)
        (off, size, stored), = blocks
        assert not stored
        streams.append(frame[off: off + size])
    return streams, plains


def _rows(streams, width=M):
    comp = np.zeros((len(streams), width), np.uint8)
    lens = np.zeros(len(streams), np.int32)
    for i, s in enumerate(streams):
        comp[i, :len(s)] = s
        lens[i] = len(s)
    return comp, lens


def _both(comp, lens, hist, out_cap=B):
    want = jax_dec.decode_blocks_batch(
        jnp.asarray(comp), jnp.asarray(lens), jnp.asarray(hist), out_cap)
    got = pt_dec.decode_blocks_batch(torch.from_numpy(comp),
                                     torch.from_numpy(lens),
                                     torch.from_numpy(hist), out_cap)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy().astype(np.int32),
                                  np.asarray(want[0]))
    return got


def test_decode_blocks_batch_matches_jax():
    streams, plains = _streams(1)
    comp, lens = _rows(streams)
    out, out_len = _both(comp, lens, np.zeros((len(streams), W), np.uint8))
    for i, p in enumerate(plains):
        assert out[i, :out_len[i]].numpy().tobytes() == p.tobytes()
    rounds = pt_dec.decode_blocks_batch.last_rounds
    assert rounds["orbit"] >= 2 and rounds["chase"] >= 1


def test_history_matches_span_into_output():
    """Blocks encoded against a 64 KB history: matches start in the
    history and run on into the block's own output."""
    data = mixed_payload(3 * B, 2)
    d = np.tile(data[:5000], 3)[:12000]
    rows, hist = [], np.zeros((3, W), np.uint8)
    for i in range(3):
        h = np.concatenate([d, data[: i * 20000]])[-W:]
        hist[i, W - len(h):] = h
        rows.append(pt_enc.encode_block_host(
            np.concatenate([d[-300:], data[i * 20000: i * 20000 + 30000]]),
            h, device="cpu"))
    comp, lens = _rows(rows)
    _both(comp, lens, hist)


@pytest.mark.parametrize("seed", [3, 4])
def test_hostile_blocks_match_jax(seed):
    """Random bytes, truncated and bit-flipped streams, 0xFF runs: JAX's
    clipped output (and out_len, which may pass out_cap) exactly."""
    rng = np.random.default_rng(seed)
    streams, _ = _streams(seed)
    s = streams[1].copy()
    s[rng.integers(0, len(s), 40)] ^= np.uint8(1 << int(rng.integers(8)))
    hostile = [rng.integers(0, 256, M, dtype=np.uint8),
               rng.integers(0, 256, 3000, dtype=np.uint8), s,
               streams[0][: len(streams[0]) // 2],
               np.full(5000, 0xFF, np.uint8),
               np.concatenate([[0xF0], np.full(300, 0xFF, np.uint8)])
               .astype(np.uint8),
               np.frombuffer(b"\x1f\x00\x00\x00\xff\xff", np.uint8)]
    comp, lens = _rows(hostile)
    comp[0] = rng.integers(0, 256, M, dtype=np.uint8)   # bytes past comp_len
    hist = np.zeros((len(hostile), W), np.uint8)
    hist[:, -7000:] = rng.integers(0, 256, 7000, dtype=np.uint8)
    _both(comp, lens, hist)
    _both(comp[:, :16 * KB], lens.clip(max=16 * KB), hist, out_cap=8 * KB)


def test_chunked_rows_match_jax(monkeypatch):
    """Row chunking (XLA_CHUNK_POSITIONS) changes no byte."""
    streams, _ = _streams(5)
    comp, lens = _rows(streams)
    monkeypatch.setattr(pt_dec, "XLA_CHUNK_POSITIONS", 2 * M)
    _both(comp, lens, np.zeros((len(streams), W), np.uint8))


@pytest.mark.parametrize("history", [False, True])
def test_decode_block_host_matches_jax(history):
    streams, plains = _streams(6)
    h = mixed_payload(80_000, 6) if history else None
    for s in streams[:2] + [np.random.default_rng(6).integers(
            0, 256, 2000, dtype=np.uint8)]:
        want = jax_dec.decode_block_host(s, B, h)
        got = pt_dec.decode_block_host(s, B, h, device="cpu")
        np.testing.assert_array_equal(got, want)


def test_concat_blocks_matches_jax():
    """Empty rows, full rows, and a row length past the row width."""
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 256, (6, 4096), dtype=np.uint8)
    for lens in ([0, 4096, 17, 0, 4000, 1], [4096, 0, 0, 0, 0, 0],
                 [0] * 6, [5000, 3, 0, 9000, 2, 4096]):
        lens = np.array(lens, np.int32)
        cap = 6 * 4096
        flat, total = jax_as.concat_blocks(jnp.asarray(rows),
                                           jnp.asarray(lens), cap)
        got, got_total = pt_as.concat_blocks(torch.from_numpy(rows),
                                             torch.from_numpy(lens), cap)
        assert int(got_total) == int(total)
        np.testing.assert_array_equal(got.numpy(), np.asarray(flat))


def test_decode_linked_scan_matches_jax():
    """A linked 64 KB frame's blocks (one stored, one empty row) with a
    dictionary window, against JAX's lax.scan."""
    rng = np.random.default_rng(8)
    data = np.concatenate([mixed_payload(2 * B, 8),
                           rng.integers(0, 256, B, dtype=np.uint8),
                           make_compressible(B - 5000)])
    d = mixed_payload(40_000, 9)
    frame = pt.compress_frame(data, pt.FrameConfig(block_size=B),
                              dictionary=d, engine="xla", device="cpu")
    _, blocks, _ = parse_block_index(frame)
    assert [st for _, _, st in blocks] == [False, False, True, False]
    rows = [frame[off: off + size] for off, size, _ in blocks] + [[]]
    comp, lens = _rows(rows, width=B + 512)
    stored = np.array([st for _, _, st in blocks] + [False], np.int32)
    window, _ = _dict_window(d)
    init = np.zeros(W, np.uint8)
    init[W - len(window):] = window
    want = jax_lk.decode_linked_scan(
        jnp.asarray(comp), jnp.asarray(lens), jnp.asarray(stored),
        jnp.asarray(init), jnp.int32(len(window)), B)
    got = pt_lk.decode_linked_scan(
        torch.from_numpy(comp), torch.from_numpy(lens),
        torch.from_numpy(stored), torch.from_numpy(init), B)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy().astype(np.int32),
                                  np.asarray(want[0]))
    assert got[0][:4].numpy().reshape(-1)[: len(data)].tobytes() \
        == data.tobytes()
    assert pt_lk.decode_linked_scan.last_syncs > 4


CFG = pt.FrameConfig(block_size=B, block_independence=True,
                     content_checksum=True)
LINKED = pt.FrameConfig(block_size=B, content_checksum=True)


@functools.lru_cache(maxsize=None)
def _frames():
    """(name, frame, dictionary, plaintext): frames from every encoder of
    the port, independent and linked, and from the host encoder (made once
    per test process)."""
    data = mixed_payload(100_000, 10)
    d = np.array(data[5000:25000])
    rng = np.random.default_rng(10)
    stored = np.concatenate([data[:70_000],
                             rng.integers(0, 256, B, dtype=np.uint8)])
    out = []
    for engine in ("split", "pallas", "hybrid", "xla"):
        out.append((f"{engine}_independent",
                    pt.compress_frame(data, CFG, engine=engine,
                                      device="cpu"), None, data))
        out.append((f"{engine}_linked_dictionary",
                    pt.compress_frame(data, LINKED, dictionary=d,
                                      engine=engine, device="cpu"), d, data))
    out.append(("xla_stored_block", pt.compress_frame(
        stored, CFG, engine="xla", device="cpu"), None, stored))
    out.append(("host_linked_block_checksums", np.asarray(lz4.compress(
        data, config=FrameConfig(block_size=B, block_checksums=True))),
        None, data))
    out.append(("host_default", np.asarray(lz4.compress(data)), None, data))
    out.append(("host_256k_dictionary", np.asarray(lz4.compress(
        data, dictionary=d, config=FrameConfig(block_size=256 * KB,
                                               block_independence=True))),
        d, data))
    return out


@pytest.mark.parametrize("engine", ["xla", "hybrid"])
def test_frames_of_every_encoder_match_jax(engine):
    for name, frame, d, data in _frames():
        want = np.asarray(device_decompress_frame(frame, dictionary=d,
                                                  engine=engine))
        got = pt.decompress_frame(frame, dictionary=d, engine=engine,
                                  device="cpu")
        assert got.tobytes() == want.tobytes() == data.tobytes(), name
    plain = [(f, x) for _, f, d, x in _frames() if d is None]
    outs = pt.decompress_frames([f for f, _ in plain], engine=engine,
                                device="cpu")
    assert [o.tobytes() for o in outs] == [x.tobytes() for _, x in plain]


def _bad(kind):
    data = mixed_payload(100_000, 11)
    d = np.array(data[:9000])
    if kind in ("no_dictionary", "wrong_dictionary"):
        frame = pt.compress_frame(data, CFG, dictionary=d, engine="xla",
                                  device="cpu")
        return frame, (None if kind == "no_dictionary"
                       else np.frombuffer(b"another dictionary" * 9,
                                          np.uint8))
    cfg = CFG.with_(block_checksums=True)
    frame = pt.compress_frame(data, cfg, engine="xla", device="cpu").copy()
    frame[20 if kind == "block_checksum" else -1] ^= 0x01
    return frame, None


@pytest.mark.parametrize("engine", ["xla", "hybrid"])
@pytest.mark.parametrize("kind", ["no_dictionary", "wrong_dictionary",
                                  "block_checksum", "content_checksum"])
def test_errors_match_jax(kind, engine):
    frame, d = _bad(kind)
    with pytest.raises(ValueError) as ref:
        device_decompress_frame(frame, dictionary=d, engine=engine)
    with pytest.raises(ValueError) as got:
        pt.decompress_frame(frame, dictionary=d, engine=engine, device="cpu")
    assert str(got.value) == str(ref.value)
    assert str(got.value).startswith("LZ4: ")


@pytest.mark.parametrize("linked", [False, True])
def test_corrupt_block_decodes_as_jax(linked):
    """A flipped byte inside a compressed block of a frame without
    checksums: the XLA decoder gives JAX's clipped bytes, unflagged."""
    data = mixed_payload(150_000, 12)
    cfg = pt.FrameConfig(block_size=B, block_independence=not linked)
    frame = pt.compress_frame(data, cfg, engine="xla", device="cpu").copy()
    frame[40] ^= 0x5A
    frame[30_000] ^= 0x0F
    for engine in ("xla", "hybrid"):
        want = np.asarray(device_decompress_frame(frame, engine=engine))
        got = pt.decompress_frame(frame, engine=engine, device="cpu")
        assert got.tobytes() == want.tobytes()
        assert got.tobytes() != data.tobytes()


@pytest.mark.cuda
def test_cuda_decode_matches_cpu(cuda):
    """The XLA decoder on the card equals the port on the CPU: rows
    (hostile ones too) and frames, independent and linked."""
    rng = np.random.default_rng(13)
    streams, _ = _streams(13)
    comp, lens = _rows(streams + [rng.integers(0, 256, M, dtype=np.uint8)])
    hist = np.zeros((len(lens), W), np.uint8)
    hist[:, -3000:] = rng.integers(0, 256, 3000, dtype=np.uint8)
    want = pt_dec.decode_blocks_batch(torch.from_numpy(comp),
                                      torch.from_numpy(lens),
                                      torch.from_numpy(hist), B)
    got = pt_dec.decode_blocks_batch(torch.from_numpy(comp).to(cuda),
                                     torch.from_numpy(lens).to(cuda),
                                     torch.from_numpy(hist).to(cuda), B)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    for name, frame, d, data in _frames():
        out = pt.decompress_frame(frame, dictionary=d, engine="xla",
                                  device=cuda)
        assert out.tobytes() == data.tobytes(), name
