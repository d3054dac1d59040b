"""The parallel match resolution of the port's two chain decoders, held
against the JAX package and the serial plain versions on the CPU.

``decode_chains_resolved`` and ``decode_token_chains_resolved`` are the
plain PyTorch rendition of what ``csrc/chain_decode.cu`` and
``csrc/token_decode.cu`` now compute: spans (from records, with the
conformance flag, or from rows parsed alone, with the cursor scan and the
cap re-parse), one source per output byte, pointer doubling and gather,
segment by segment. They must give the JAX wave decoder's bytes
(``decompress_frame_waves`` in interpret mode), the JAX split engine's on
the frames its wave planner declines, the JAX
``decode_linked_chunk_pallas`` (interpret mode) on linked rows, and the
serial plain versions on hostile records and on a chain whose region is
smaller than its rows decode to. Tolerance: exact bytes everywhere.
The ``cuda`` tests hold the kernels against the plain versions on the
same batches and check the launch counters, the serial-route counts of
the record path and the token path's scratch bytes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divortio_lz4_tpu as lz4
from _torch_port import cuda  # noqa: F401  (fixture)
from divortio_lz4_tpu.config import FrameConfig
from divortio_lz4_tpu.ops import pallas_decode as jax_pd
from divortio_lz4_tpu.ops.wave_decode import decompress_frame_waves
from divortio_lz4_tpu.parallel.device import device_decompress_frame
from divortio_lz4_tpu_torch import _build
from divortio_lz4_tpu_torch.ops import resolve as rs
from divortio_lz4_tpu_torch.ops import token_decode as pt_td
from divortio_lz4_tpu_torch.ops import wave_decode as pt_wd
from divortio_lz4_tpu_torch.parallel.device import parse_block_index
from test_torch_token_decode import _linked_rows, _records
from test_torch_wave import (CHAIN_CASES, _batch_for_hostile, _chain_frame,
                             _dense_sequence_block, _rle_block)

KB, MB, W = 1024, 1048576, 65536


def _chains(frame, window=None, device="cpu"):
    header, blocks, _ = parse_block_index(frame)
    return pt_wd.stage_chains(frame, blocks, header, window, device)


@pytest.mark.parametrize("case", list(CHAIN_CASES))
def test_resolved_chains_match_jax_waves(case):
    """Every parser-built chain conforms; one segment or many, the
    resolved bytes are the JAX wave decoder's."""
    frame, data, d = _chain_frame(case)
    header, blocks, _ = parse_block_index(frame)
    window = None if d is None else d[-W:]
    want = decompress_frame_waves(frame, blocks, header, window,
                                  interpret=True)
    batch = pt_wd.stage_chains(frame, blocks, header, window, "cpu")
    for segment in (None, 1 << 17):
        got, stats = pt_wd.decode_chains_resolved(batch, segment)
        assert stats["serial_chains"] == 0
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), data)


@pytest.mark.parametrize("kind", ["giant_rle", "record_overflow"])
def test_resolved_chains_frames_jax_declines(kind):
    if kind == "giant_rle":
        raw = np.zeros(MB + 1000, np.uint8)
    else:
        n_seq = 60_000
        raw = np.asarray(lz4.decompress_raw(np.frombuffer(
            _dense_sequence_block(n_seq), np.uint8), n_seq * 5 + 5))
    frame = np.asarray(lz4.compress(raw, config=FrameConfig(
        block_size=MB, block_independence=True)))
    got, stats = pt_wd.decode_chains_resolved(_chains(frame))
    assert stats["serial_chains"] == 0
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(device_decompress_frame(frame,
                                                        engine="split")))
    np.testing.assert_array_equal(got.numpy(), raw)


def _hostile_records():
    batch, _ = _batch_for_hostile()
    r0, r1 = int(batch.rec_off[1]), int(batch.rec_off[2])
    rng = np.random.default_rng(44)
    words = batch.rec_words.clone()
    words[r0:r1] = torch.from_numpy(rng.integers(
        -2**31, 2**31, (r1 - r0, 3), dtype=np.int64).astype(np.int32))
    return batch._replace(rec_words=words)


def test_random_record_chain_does_not_conform():
    """Random words in chain 1: only that chain fails the conformance
    check, and it decodes serially to the plain version's bytes."""
    batch = _hostile_records()
    conform, _, _ = pt_wd.record_spans(batch)
    assert conform.tolist() == [i != 1 for i in range(len(conform))]
    got, stats = pt_wd.decode_chains_resolved(batch, 1 << 18)
    assert stats["serial_chains"] == 1
    assert torch.equal(got, pt_wd.decode_chains_plain(batch))


def test_overlapping_chains_take_the_serial_route():
    """Chains whose records overlap get no spans: every chain decodes with
    the serial walk, as the kernel routes them."""
    frame, _, _ = _chain_frame("independent_1m")
    batch = _chains(frame)
    rec_off = batch.rec_off.clone()
    rec_off[2] = rec_off[1] - 10     # chain 2 starts inside chain 0's
    bad = batch._replace(rec_off=rec_off)
    assert pt_wd.record_spans(bad) is None
    got, stats = pt_wd.decode_chains_resolved(bad)
    assert stats["serial_chains"] == batch.rec_off.shape[0] - 1
    assert torch.equal(got, pt_wd.decode_chains_plain(bad))


def _token_batch(rows, stored, window, bs, row_off=None, out_off=None):
    comp_off = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    n = len(rows)
    row_off = np.array([0, n]) if row_off is None else row_off
    out_off = row_off * bs if out_off is None else out_off
    return pt_td.TokenChains(
        torch.from_numpy(np.concatenate(rows)),
        torch.from_numpy(comp_off.astype(np.int64)),
        torch.from_numpy(np.asarray(stored, np.uint8)),
        torch.from_numpy(row_off.astype(np.int64)),
        torch.from_numpy(out_off.astype(np.int64)),
        None if window is None else torch.from_numpy(window), bs,
        int(out_off[-1]))


@pytest.mark.parametrize("kind", ["frame", "hostile"])
def test_resolved_tokens_match_jax_linked_chunk(kind):
    rows, stored, window, bs = _linked_rows(kind, np.random.default_rng(9))
    M = -(-(max(len(r) for r in rows) + 256) // 1024) * 1024
    comp = np.zeros((len(rows), M), np.uint8)
    lens = np.array([len(r) for r in rows], np.int64)
    for i, r in enumerate(rows):
        comp[i, : len(r)] = r
    jo, jt, jl, _ = jax_pd.decode_linked_chunk_pallas(
        jnp.asarray(comp), jnp.asarray(lens.astype(np.int32)),
        jnp.asarray(stored), jnp.asarray(window), bs, True)
    batch = _token_batch(rows, stored, window, bs)
    for segment in (None, 1000):
        out, out_lens, _ = pt_td.decode_token_chains_resolved(batch,
                                                              segment)
        np.testing.assert_array_equal(out_lens.numpy(), np.asarray(jl))
        total = int(jt)
        np.testing.assert_array_equal(out[:total].numpy(),
                                      np.asarray(jo)[:total])
        assert not out[total:].any()


def test_resolved_tokens_cap_binds_mid_row():
    """A chain whose region is smaller than its rows decode to: the cap
    binds inside one row, which is parsed again; later rows give 0."""
    rows, stored, window, bs = _linked_rows("frame",
                                            np.random.default_rng(9))
    n = len(rows)
    full = _token_batch(rows, stored, window, bs)
    lens = pt_td.decode_token_chains_plain(full)[1].numpy()
    cap = int(lens[:2].sum() + lens[2] // 2)   # mid-row 2
    # two chains: all rows in a short region, then every row again
    rows2 = rows + rows
    row_off = np.array([0, n, 2 * n])
    out_off = np.array([0, cap, cap + n * bs])
    batch = _token_batch(rows2, np.concatenate([stored, stored]), window,
                         bs, row_off, out_off)
    want = pt_td.decode_token_chains_plain(batch)
    got = pt_td.decode_token_chains_resolved(batch, 4096)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ol = got[1].numpy()
    assert ol[:n].sum() == cap and 0 < ol[2] < lens[2]
    assert not ol[3:n].any()
    np.testing.assert_array_equal(ol[n:], lens)


def test_rows_ending_before_they_start_are_exact():
    """A comp_off that decreases: the row whose end lies before its start
    is empty and the next one reads from its own start, as in the plain
    version (each row owns its span slots, wherever its bytes lie)."""
    rows, stored, window, bs = _linked_rows("frame",
                                            np.random.default_rng(9))
    batch = _token_batch(rows, stored, window, bs)
    comp_off = batch.comp_off.clone()
    comp_off[2] = comp_off[1] - 7     # row 1 ends before it starts
    bad = batch._replace(comp_off=comp_off)
    got = pt_td.decode_token_chains_resolved(bad)
    want = pt_td.decode_token_chains_plain(bad)
    assert int(want[1][1]) == 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _running_max(batch):
    return batch._replace(row_off=torch.cummax(batch.row_off, 0).values,
                          out_off=torch.cummax(batch.out_off, 0).values)


def _decreasing_chains():
    """Three chains of the same rows whose row_off and out_off decrease:
    chain 1 starts inside chain 0's rows and region."""
    rows, stored, window, bs = _linked_rows("frame",
                                            np.random.default_rng(9))
    n = len(rows)
    row_off = np.array([0, n, n - 2, 2 * n])
    out_off = np.array([0, n * bs, n * bs - 5000, 2 * n * bs])
    return _token_batch(rows + rows, np.concatenate([stored, stored]),
                        window, bs, row_off, out_off)


def test_decreasing_chain_offsets_read_as_running_max():
    """row_off and out_off are read as their running maxima, as the
    kernels read them: no two chains share a row or an output byte."""
    batch = _decreasing_chains()
    got = pt_td.decode_token_chains_resolved(batch)
    want = pt_td.decode_token_chains_plain(_running_max(batch))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("kind", ["frame", "hostile", "random", "dense"])
def test_span_slots_hold_every_parse(kind):
    """The kernel gives a compressed row of len bytes len // 3 + 1 span
    slots: no parse, at any output limit, records more spans (a span is
    a sequence that writes a byte)."""
    rng = np.random.default_rng(12)
    if kind in ("frame", "hostile"):
        rows = _linked_rows(kind, rng)[0]
    elif kind == "random":
        rows = [rng.integers(0, 256, int(n), dtype=np.uint8)
                for n in rng.integers(1, 3000, 16)]
    else:
        # three bytes a sequence: token 0x00, offset 1, a 4-byte match
        rows = [np.frombuffer(b"\x00\x01\x00" * k, np.uint8)
                for k in (1, 2, 3, 100, 1000)]
    comp = torch.from_numpy(np.concatenate(rows))
    lens = torch.tensor([len(r) for r in rows])
    start = torch.cumsum(lens, 0) - lens
    st = pt_td._Stream(comp)
    for limit in (1, 5, 64, 4096, 1 << 20):
        o = torch.full((len(rows),), W)
        lits, matches = [], []
        pt_td._parse(st, start, lens, o, o + limit, lits, matches)
        spans = sum(((lit[2] > 0) | (m[2] > 0)).long()
                    for lit, m in zip(lits, matches))
        assert bool((spans <= lens // 3 + 1).all())
    if kind == "dense":
        assert spans.tolist() == (lens // 3).tolist()


def test_offset1_run_is_one_hop():
    """A 1 MB offset-1 run: every match byte's parent is the literal (the
    kernel's periodic source), so one round makes every byte final."""
    n = MB
    block = np.frombuffer(_rle_block(n), np.uint8)
    batch = _token_batch([block], [0], None, n)
    out, out_lens, stats = pt_td.decode_token_chains_resolved(batch)
    assert stats["rounds"] == [2]
    assert int(out_lens[0]) == n
    assert out[: n - 5].eq(ord("a")).all()
    assert bytes(out[n - 5:].numpy()) == b"ABCDE"


@pytest.mark.parametrize("shape", ["path", "random"])
def test_pointer_doubling(shape):
    """Every parent pointer ends as its byte's root's final code, within
    ceil(log2(depth)) + 2 rounds."""
    n = 5000
    rng = np.random.default_rng(3)
    if shape == "path":
        parent = np.arange(n) - 1          # depth n - 1
    else:
        parent = np.array([int(rng.integers(-1, p)) if p else -1
                           for p in range(n)])
    code = torch.from_numpy(parent.astype(np.int64))
    # parents lie before their bytes: one forward pass finds every root
    top = np.arange(n)
    hops = np.zeros(n, np.int64)
    for p in range(n):
        if parent[p] >= 0:
            top[p], hops[p] = top[parent[p]], hops[parent[p]] + 1
    final = np.where(parent >= 0, -2 - top, rs.ROOT)
    depth = int(hops.max())
    rounds = rs.pointer_double(code)
    np.testing.assert_array_equal(code.numpy(), final)
    assert rounds <= int(np.ceil(np.log2(depth))) + 2


def test_gather_takes_root_bytes():
    seg = torch.tensor([7, 0, 9, 0, 0], dtype=torch.uint8)
    code = torch.tensor([-1, -2, -1, -4, -2])
    rs.gather(seg, code)
    assert seg.tolist() == [7, 7, 9, 9, 7]


def test_rounds_for_covers_a_path():
    for n in (1, 2, 3, 1000, 1 << 20):
        code = torch.arange(n) - 1
        assert rs.pointer_double(code) <= rs.rounds_for(n)


def test_resolved_records_reach_the_dictionary():
    """A linked frame with a dictionary: match spans below a chain's first
    byte read the seed, in every segment layout."""
    frame, data, d = _chain_frame("linked_256k_dict")
    batch = _chains(frame, d[-W:])
    _, _, matches = pt_wd.record_spans(batch)
    assert bool((matches.src < matches.o0).any())
    for segment in (1 << 16, 1 << 19):
        got, _ = pt_wd.decode_chains_resolved(batch, segment)
        np.testing.assert_array_equal(got.numpy(), data)


def test_build_digest_covers_headers(tmp_path):
    """An edit to a shared header renames every CUDA library (nothing is
    compiled here)."""
    src = tmp_path / "k.cu"
    src.write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    flags = ("-O3",)
    first = _build.source_digest(str(src), flags)
    assert _build.source_digest(str(src), flags) == first
    (tmp_path / "shared.cuh").write_text("// v2\n")
    second = _build.source_digest(str(src), flags)
    assert second != first
    (tmp_path / "other.cuh").write_text("// new\n")
    assert _build.source_digest(str(src), flags) != second
    assert _build.source_digest(str(src), ("-O2",)) != \
        _build.source_digest(str(src), flags)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _on(batch, dev):
    return type(batch)(*(x.to(dev) if torch.is_tensor(x) else x
                         for x in batch))


@pytest.mark.cuda
def test_cuda_chain_routes(cuda):
    """Parser chains resolve in parallel (0 serial), the random-record
    chain decodes serially (1), overlapping chains all serially; each call
    counts one launch and equals the plain version."""
    frame, _, _ = _chain_frame("independent_1m")
    good = _chains(frame)
    rec_off = good.rec_off.clone()
    rec_off[2] = rec_off[1] - 10
    for batch, serial in ((good, 0), (_hostile_records(), 1),
                          (good._replace(rec_off=rec_off),
                           good.rec_off.shape[0] - 1)):
        want = pt_wd.decode_chains_plain(batch)
        before = pt_wd.decode_chains.launches
        got = pt_wd.decode_chains(_on(batch, cuda))
        torch.cuda.synchronize()
        assert pt_wd.decode_chains.launches == before + 1
        assert pt_wd.decode_chains.last.stats()["serial_chains"] == serial
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_token_routes(cuda):
    """The cap re-parse, decreasing chain offsets (read as their running
    maxima), 2500 one-row chains of random bytes (more rows and chains
    than the slot kernel's one CTA has threads) and an offset-1 run of
    1 MB (one round) on the card, each equal to the plain version."""
    rows, stored, window, bs = _linked_rows("frame",
                                            np.random.default_rng(9))
    n = len(rows)
    lens = pt_td.decode_token_chains_plain(
        _token_batch(rows, stored, window, bs))[1].numpy()
    cap = int(lens[:2].sum() + lens[2] // 2)
    clipped = _token_batch(rows + rows, np.concatenate([stored, stored]),
                           window, bs, np.array([0, n, 2 * n]),
                           np.array([0, cap, cap + n * bs]))
    decreasing = _decreasing_chains()
    rng = np.random.default_rng(14)
    k = 2500
    many = _token_batch([rng.integers(0, 256, int(n), dtype=np.uint8)
                         for n in rng.integers(1, 64, k)],
                        rng.integers(0, 2, k), None, 256, np.arange(k + 1),
                        np.arange(k + 1) * 256)
    run = _token_batch([np.frombuffer(_rle_block(MB), np.uint8)], [0], None,
                       MB)
    for batch, plain in ((clipped, clipped),
                         (decreasing, _running_max(decreasing)),
                         (many, many), (run, run)):
        want = pt_td.decode_token_chains_plain(plain)
        before = pt_td.decode_token_chains.launches
        got = pt_td.decode_token_chains(_on(batch, cuda))
        torch.cuda.synchronize()
        assert pt_td.decode_token_chains.launches == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    assert pt_td.decode_token_chains.last.stats()["rounds"] == 2


@pytest.mark.cuda
def test_cuda_stored_chain_scratch(cuda):
    """A chain of 8 stored 1 MB rows takes one span slot a row: the
    scratch is the segment's 4 B codes and the long-span list, with no
    term per wire byte."""
    rng = np.random.default_rng(13)
    rows = [rng.integers(0, 256, MB, dtype=np.uint8) for _ in range(8)]
    batch = _token_batch(rows, [1] * 8, None, MB)
    got = pt_td.decode_token_chains(_on(batch, cuda))
    want = pt_td.decode_token_chains_plain(batch)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    total = batch.out_total
    assert bytes(got[0].cpu().numpy()) == np.concatenate(rows).tobytes()
    assert pt_td.decode_token_chains.last.stats()["scratch_bytes"] \
        < 4 * total + total // 8


@pytest.mark.cuda
def test_cuda_resolves_in_segments(cuda, monkeypatch):
    """Small segments on the card: parents in earlier segments count as
    roots, as in the rendition."""
    monkeypatch.setattr(pt_wd, "SEGMENT", 1 << 16)
    monkeypatch.setattr(pt_td, "SEGMENT", 1 << 16)
    frame, data, d = _chain_frame("linked_256k_dict")
    batch = _chains(frame, d[-W:], cuda)
    out = pt_wd.decode_chains(batch)
    assert pt_wd.decode_chains.last.stats()["segments"] > 1
    np.testing.assert_array_equal(out.cpu().numpy(), data)
    rows = [np.asarray(lz4.compress_raw(_records(60_000)))]
    tb = _on(_token_batch(rows, [0], None, 200_000), cuda)
    got = pt_td.decode_token_chains(tb)
    want = pt_td.decode_token_chains_plain(_on(tb, "cpu"))
    assert pt_td.decode_token_chains.last.stats()["segments"] > 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
