"""The torch port's engine="xla" encode held against the JAX package on the
CPU.

The port's encode_blocks_batch / encode_block_host (ops/encode_xla) and
assemble_blocks (ops/assemble_xla) must equal the JAX functions of the
same names on the same numpy inputs, row for row, out_len and the zero
tail included; compress_frame must equal the JAX device_compress_frame
on every route that reaches the XLA encoder (engine="xla", engine="pallas"
with a dictionary or on linked frames, "split" and "hybrid" big blocks
with assemble="device") and on the host frame encoder's route (linked
frames with block checksums). Tolerance: 0, byte for byte everywhere.
The rows reuse a few widths so that JAX compiles few programs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divortio_lz4_tpu as lz4
import divortio_lz4_tpu_torch as pt
from _torch_port import cuda, mixed_payload  # noqa: F401  (cuda: fixture)
from _torch_port import one_torch_thread  # noqa: F401  (fixture)
from conftest import make_compressible
from divortio_lz4_tpu import frame as jax_frame
from divortio_lz4_tpu.config import FrameConfig
from divortio_lz4_tpu.ops import assemble_xla as jax_as
from divortio_lz4_tpu.ops import encode_xla as jax_enc
from divortio_lz4_tpu.parallel.device import device_compress_frame
from divortio_lz4_tpu_torch import frame as pt_frame
from divortio_lz4_tpu_torch.ops import assemble_xla as pt_as
from divortio_lz4_tpu_torch.ops import encode_xla as pt_enc

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KB = 1024
W = 65536
B = 64 * KB


def _rows(seed: int) -> list:
    """Eight 64 KB-row payloads: JSON-like, zeros, random, shorter than
    13 bytes, empty, a 3-symbol alphabet, a long-period text, a mix."""
    rng = np.random.default_rng(seed)
    return [make_compressible(B), np.zeros(B, np.uint8),
            rng.integers(0, 256, B, dtype=np.uint8),
            np.frombuffer(b"abcabcabcab", np.uint8), np.zeros(0, np.uint8),
            rng.integers(0, 3, 40_000, dtype=np.uint8),
            np.tile(rng.integers(0, 256, 3000, dtype=np.uint8), 20)[:B],
            mixed_payload(B, seed)]


def _batch(rows, hist=None):
    hl = 0 if hist is None else W
    work = np.zeros((len(rows), hl + B), np.uint8)
    lens = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        if hist is not None:
            work[i, :W] = hist[i]
        work[i, hl: hl + len(r)] = r
        lens[i] = len(r)
    return work, lens


def _jax_batch(work, lens, hl, fp, hs):
    out, out_len = jax_enc.encode_blocks_batch(
        jnp.asarray(work), jnp.asarray(lens), hl, fp,
        jnp.asarray(np.broadcast_to(np.asarray(hs, np.int32),
                                    (len(lens),))))
    return np.asarray(out), np.asarray(out_len)


def _assert_rows_equal(got, want):
    out, out_len = got
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out_len.numpy(), want[1])
    np.testing.assert_array_equal(out.numpy().astype(np.int32), want[0])


@pytest.mark.parametrize("fingerprints", [True, False])
def test_encode_blocks_batch_matches_jax(fingerprints):
    work, lens = _batch(_rows(1))
    want = _jax_batch(work, lens, 0, fingerprints, 0)
    got = pt_enc.encode_blocks_batch(torch.from_numpy(work),
                                     torch.from_numpy(lens), 0, fingerprints)
    _assert_rows_equal(got, want)
    assert want[1][4] == 0 and want[1][3] == 12   # empty row; 1 + 11 literals
    rounds = pt_enc.encode_blocks_batch.last_rounds
    assert rounds["orbit"] >= 2 and (rounds["lce"] > 0) == fingerprints


def test_encode_with_history_matches_jax():
    """[64 KB history | payload] rows, a different hist_start per row
    (none, a short dictionary, a full window), matches that reach back into
    the history."""
    data = mixed_payload(5 * B, 4)
    rows = [data[B * (i + 1): B * (i + 2) - 7000 * i] for i in range(4)]
    hist = np.zeros((4, W), np.uint8)
    hs = np.array([W, W - 3000, 0, W - 40_000], np.int32)
    for i in range(4):
        hist[i, hs[i]:] = data[B * (i + 1) - (W - hs[i]): B * (i + 1)]
    work, lens = _batch(rows, hist)
    for fp in (True, False):
        want = _jax_batch(work, lens, W, fp, hs)
        got = pt_enc.encode_blocks_batch(torch.from_numpy(work),
                                         torch.from_numpy(lens), W, fp,
                                         torch.from_numpy(hs))
        _assert_rows_equal(got, want)
    # the history helps: the full-window row beats its no-history twin
    assert want[1][2] < _jax_batch(work[2:3, W:], lens[2:3], 0, False, 0)[1][0]


def test_chunked_rows_match_jax(monkeypatch):
    """Row chunking (XLA_CHUNK_POSITIONS) changes no byte."""
    work, lens = _batch(_rows(5))
    want = _jax_batch(work, lens, 0, True, 0)
    monkeypatch.setattr(pt_enc, "XLA_CHUNK_POSITIONS", 3 * B)
    _assert_rows_equal(pt_enc.encode_blocks_batch(
        torch.from_numpy(work), torch.from_numpy(lens), 0, True), want)


@pytest.mark.parametrize("history", [False, True])
def test_encode_block_host_matches_jax(history):
    data = make_compressible(20_000)
    h = mixed_payload(30_000, 6) if history else None
    want = jax_enc.encode_block_host(data, h)
    got = pt_enc.encode_block_host(data, h, device="cpu")
    np.testing.assert_array_equal(got, want)
    dst = np.zeros(len(data), np.uint8)
    assert lz4.decompress_raw(got, dst, dictionary=h) == len(data)
    assert dst.tobytes() == data.tobytes()


def test_assemble_blocks_matches_jax():
    """Compressed, stored (no gain, or out_len 0) and empty rows."""
    rng = np.random.default_rng(7)
    rows = [make_compressible(B), rng.integers(0, 256, 5000, dtype=np.uint8),
            np.zeros(0, np.uint8), np.zeros(3000, np.uint8),
            mixed_payload(B, 8)]
    work, lens = _batch(rows)
    outs, out_lens = _jax_batch(work, lens, 0, True, 0)
    out_lens = out_lens.copy()
    out_lens[3] = 0                              # a row the encoder refused
    cap = len(rows) * (4 + B) + 4
    body, total = jax_as.assemble_blocks(
        jnp.asarray(outs), jnp.asarray(out_lens), jnp.asarray(work),
        jnp.asarray(lens), cap)
    got, got_total = pt_as.assemble_blocks(
        torch.from_numpy(outs.astype(np.uint8)), torch.from_numpy(out_lens),
        torch.from_numpy(work), torch.from_numpy(lens), cap)
    assert int(got_total) == int(total)
    np.testing.assert_array_equal(got.numpy().astype(np.int32),
                                  np.asarray(body))


def _data_dict(n=150_000, seed=9):
    data = mixed_payload(n, seed)
    return data, np.array(data[2000:34000])


CFG = FrameConfig(block_size=B, block_independence=True)
LINKED = FrameConfig(block_size=B)
# (engine, config, dictionary?, keyword arguments) per route
ROUTES = {
    "xla_independent_checksum": ("xla", CFG.with_(content_checksum=True),
                                 False, {}),
    "xla_dictionary": ("xla", CFG, True, {}),
    "xla_assemble_device": ("xla", CFG.with_(content_checksum=True), False,
                            {"assemble": "device"}),
    "xla_favor_ratio_off": ("xla", CFG.with_(favor_ratio=False), False, {}),
    "xla_no_fingerprints": ("xla", CFG, False, {"use_fingerprints": False}),
    "xla_linked": ("xla", LINKED, False, {}),
    "xla_linked_dictionary": ("xla", LINKED.with_(content_checksum=True),
                              True, {}),
    "xla_linked_assemble_device": ("xla", LINKED, True,
                                   {"assemble": "device"}),
    "xla_linked_block_checksums": ("xla", LINKED.with_(block_checksums=True),
                                   False, {}),
    "pallas_dictionary": ("pallas", CFG, True, {}),
    "pallas_linked": ("pallas", LINKED, False, {}),
    "hybrid_linked_block_checksums": (
        "hybrid", LINKED.with_(block_checksums=True), True, {}),
    "hybrid_assemble_device": ("hybrid", LINKED, False,
                               {"assemble": "device"}),
    "split_256k_assemble_device": (
        "split", FrameConfig(block_size=256 * KB, block_independence=True),
        False, {"assemble": "device"}),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_frame_route_matches_jax(route):
    engine, cfg, use_dict, kw = ROUTES[route]
    data, d = _data_dict()
    d = d if use_dict else None
    want = np.asarray(device_compress_frame(data, cfg, dictionary=d,
                                            engine=engine, **kw))
    got = pt.compress_frame(data, cfg, dictionary=d, engine=engine,
                            device="cpu", **kw)
    assert got.tobytes() == want.tobytes()
    out = pt.decompress_frame(got, dictionary=d, engine="split",
                              device="cpu")
    assert out.tobytes() == data.tobytes()


def test_empty_and_tiny_payloads_match_jax():
    for data in (b"", b"Hello World"):
        for cfg in (CFG, LINKED, LINKED.with_(block_checksums=True)):
            for kw in ({}, {"assemble": "device"}):
                want = np.asarray(device_compress_frame(data, cfg,
                                                        engine="xla", **kw))
                got = pt.compress_frame(data, cfg, engine="xla",
                                        device="cpu", **kw)
                assert got.tobytes() == want.tobytes(), (data, cfg, kw)


def test_default_config_frame_matches_jax():
    """FrameConfig(): one 4 MB linked block, [64 KB history | 4 MB] row."""
    data = mixed_payload(150_000, 10)
    want = np.asarray(device_compress_frame(data, FrameConfig(),
                                            engine="xla"))
    got = pt.compress_frame(data, pt.FrameConfig(), engine="xla",
                            device="cpu")
    assert got.tobytes() == want.tobytes()
    assert pt.decompress_frame(got, engine="xla",
                               device="cpu").tobytes() == data.tobytes()


@pytest.mark.parametrize("cfg", [LINKED.with_(block_checksums=True),
                                 CFG.with_(block_checksums=True,
                                           content_checksum=True),
                                 FrameConfig(block_size=256 * KB,
                                             content_size=False)],
                         ids=["linked", "independent", "linked_256k"])
def test_host_frame_encoder_matches_jax(cfg):
    data, d = _data_dict(300_000, 11)
    for dictionary in (None, d):
        want = np.asarray(jax_frame.compress_frame(data, dictionary, cfg))
        got = pt_frame.compress_frame(data, dictionary, cfg)
        assert got.tobytes() == want.tobytes()


@pytest.mark.cuda
def test_cuda_encode_matches_cpu(cuda):
    """The XLA encoder on the card equals the port on the CPU, rows and
    frames, independent and linked."""
    work, lens = _batch(_rows(12))
    for fp in (True, False):
        want = pt_enc.encode_blocks_batch(torch.from_numpy(work),
                                          torch.from_numpy(lens), 0, fp)
        got = pt_enc.encode_blocks_batch(torch.from_numpy(work).to(cuda),
                                         torch.from_numpy(lens).to(cuda), 0,
                                         fp)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
    data, d = _data_dict()
    for cfg in (CFG, LINKED):
        for kw in ({}, {"assemble": "device"}):
            want = pt.compress_frame(data, cfg, dictionary=d, engine="xla",
                                     device="cpu", **kw)
            got = pt.compress_frame(data, cfg, dictionary=d, engine="xla",
                                    device=cuda, **kw)
            assert got.tobytes() == want.tobytes()
