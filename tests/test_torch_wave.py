"""The torch port's chain and wide-block decode held against the JAX package
on the CPU.

decompress_frame_chains must equal the JAX decompress_frame_waves (its wave
kernel in interpret mode) on linked frames of every block size and on
independent big blocks; decode_blocks_wire must equal the JAX
decode_blocks_wire (interpret mode) on parse_wire_batch output. Frames the
JAX planner declines (giant RLE, record overflow) decode on the port
itself and equal device_decompress_frame(engine="split"); hostile frames
raise the JAX package's "LZ4: ..." errors. Tolerance: exact bytes
everywhere (comparisons cover each block's [0, out_len)).
"""

import numpy as np
import pytest
import torch

import divortio_lz4_tpu as lz4
import divortio_lz4_tpu_torch as pt
from _torch_port import cuda  # noqa: F401  (fixture)
from divortio_lz4_tpu.config import FrameConfig
from divortio_lz4_tpu.ops import pallas_split_decode as jax_sd
from divortio_lz4_tpu.ops.wave_decode import decompress_frame_waves
from divortio_lz4_tpu.parallel.device import device_decompress_frame
from divortio_lz4_tpu_torch.ops import wave_decode as pt_wd
from divortio_lz4_tpu_torch.ops import wire_decode as pt_wr
from divortio_lz4_tpu_torch.parallel.device import (_frame_header_bytes,
                                                    parse_block_index)
from test_wire_decode import _cases

KB, MB = 1024, 1048576
EVENT = (b'{"ts":1700000000,"level":"info","service":"api-gateway",'
         b'"msg":"request completed","status":200,"latency_ms":42,'
         b'"path":"/v1/users/12345","trace":"abcdef0123456789"}\n')


def mixed_corpus(n: int, seed: int) -> np.ndarray:
    """tests/test_wave_decode.py's corpus: repeated JSON event records with
    600-byte patches of noise, so blocks stay compressed but carry literal
    runs."""
    rng = np.random.default_rng(seed)
    out = np.frombuffer((EVENT * (n // len(EVENT) + 1))[:n], np.uint8).copy()
    for _ in range(max(n // 40000, 1)):
        at = int(rng.integers(0, max(n - 600, 1)))
        out[at: at + 600] = rng.integers(0, 256, 600, dtype=np.uint8)
    return out


def _dense_sequence_block(n_seq: int) -> bytes:
    """n_seq minimal sequences (1 literal + a 4-byte offset-1 match) and a
    5-literal tail: one record per 5 output bytes."""
    return b"\x10A\x01\x00" * n_seq + b"\x50ABCDE"


def _dict(data):
    return np.array(data[30_000:70_000])


# (block size, independent, with dictionary, stored island)
CHAIN_CASES = {
    "linked_64k": (64 * KB, False, False, False),
    "linked_256k_dict": (256 * KB, False, True, False),
    "linked_1m": (MB, False, False, False),
    "linked_4m_dict": (4 * MB, False, True, False),
    "linked_256k_stored": (256 * KB, False, False, True),
    "independent_1m": (MB, True, False, False),
    "independent_4m_dict": (4 * MB, True, True, False),
    "independent_256k_stored": (256 * KB, True, False, True),
}


def _chain_frame(case):
    bs, indep, use_dict, stored = CHAIN_CASES[case]
    n = 2_300_000 if case == "independent_1m" else 600_000
    data = mixed_corpus(n, seed=41)
    if stored:
        rng = np.random.default_rng(42)
        data[: 300_000] = rng.integers(0, 256, 300_000, np.uint8)
    d = _dict(data) if use_dict else None
    frame = np.asarray(lz4.compress(data, dictionary=d, config=FrameConfig(
        block_size=bs, block_independence=indep, content_checksum=True)))
    return frame, data, d


@pytest.mark.parametrize("case", list(CHAIN_CASES))
def test_chains_match_jax_waves(case):
    frame, data, d = _chain_frame(case)
    header, blocks, _ = parse_block_index(frame)
    if CHAIN_CASES[case][3]:
        assert any(st for _, _, st in blocks)
    window = None if d is None else d[-65536:]
    want = decompress_frame_waves(frame, blocks, header, window,
                                  interpret=True)
    got = pt_wd.decompress_frame_chains(frame, blocks, header, window, "cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data)
    out = pt.decompress_frame(frame, dictionary=d, device="cpu")
    np.testing.assert_array_equal(out, data)


def test_chain_arrays_layout():
    """Independent blocks are one chain each, a linked frame one chain;
    dst runs over the whole chain and outputs tile the frame in order."""
    frame, data, _ = _chain_frame("independent_1m")
    header, blocks, _ = parse_block_index(frame)
    out_lens, recs_l = pt_wd.plan_blocks(frame, blocks, header, None)
    for independent in (True, False):
        wire, wire_off, words, rec_off, out_off = pt_wd.build_chain_arrays(
            frame, blocks, independent, out_lens, recs_l)
        nc = len(blocks) if independent else 1
        assert len(wire_off) == len(rec_off) == len(out_off) == nc + 1
        assert out_off[-1] == len(data) == out_lens.sum()
        assert np.all(np.diff(wire_off) >= pt_wd.SLACK)
        w = words.view(np.uint32).astype(np.int64)
        tot = ((w[:, 1] >> 16) & 0xFF) + (w[:, 1] >> 24)
        for c in range(nc):
            r = slice(rec_off[c], rec_off[c + 1])
            np.testing.assert_array_equal(
                w[r, 2], np.cumsum(tot[r]) - tot[r])
            assert tot[r].sum() == out_off[c + 1] - out_off[c]


def _numpy_chain_arrays(buf, blocks, independent, out_lens, recs_l):
    """build_chain_arrays as whole-array numpy passes, the port's packing
    before its record words moved into one native pass: the oracle of
    its five arrays."""
    SLACK, U32 = pt_wd.SLACK, pt_wd.U32
    nb = len(blocks)
    if independent:
        starts = np.arange(nb + 1)
    else:
        starts = np.array([0, nb])
    sizes = np.array([size for _, size, _ in blocks], np.int64)
    counts = np.array([len(r) for r in recs_l], np.int64)
    nc = len(starts) - 1

    def per_chain(x):
        cs = np.concatenate([[0], np.cumsum(x)])
        return cs[starts[1:]] - cs[starts[:-1]]

    chain_wire = per_chain(sizes) + SLACK
    if nc and max(chain_wire.max(), per_chain(out_lens).max()) >= U32:
        raise ValueError("chain of 4 GiB or more: its records' u32 src/dst "
                         "would wrap")
    wire_off = np.concatenate([[0], np.cumsum(chain_wire)]).astype(np.int64)
    chain_of = np.repeat(np.arange(nc), np.diff(starts))
    cum = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    in_chain = cum - cum[starts[:-1]][chain_of] if nb else cum
    wire = np.zeros(int(wire_off[-1]), np.uint8)
    for b, (off, size, _) in enumerate(blocks):
        at = int(wire_off[chain_of[b]] + in_chain[b])
        wire[at: at + size] = buf[off: off + size]

    rec_off = np.concatenate([[0], np.cumsum(per_chain(counts))]) \
        .astype(np.int64)
    out_off = np.concatenate([[0], np.cumsum(per_chain(out_lens))]) \
        .astype(np.int64)
    words = np.zeros((int(rec_off[-1]), 3), np.uint32)
    if len(words):
        r = np.concatenate(recs_l).astype(np.int64)
        tot = ((r[:, 1] >> 16) & 0xFF) + ((r[:, 1] >> 24) & 0xFF)
        run = np.cumsum(tot)
        base = np.concatenate([[0], run])[rec_off[:-1]]
        words[:, 0] = r[:, 0] + np.repeat(in_chain, counts)
        words[:, 1] = r[:, 1]
        words[:, 2] = run - tot - np.repeat(base, np.diff(rec_off))
    return wire, wire_off, words.view(np.int32), rec_off, out_off


# (block size, independent, with dictionary, stored island, plaintext bytes)
WORD_CASES = {
    "linked_4m": (4 * MB, False, False, False, 4_500_000),
    "linked_64k_dict": (64 * KB, False, True, False, 600_000),
    "independent_1m": (MB, True, False, False, 2_300_000),
    "linked_256k_stored": (256 * KB, False, False, True, 600_000),
}


def _word_inputs(case):
    """(buf, blocks, [independent], out_lens, recs_l) of a case: a parsed
    frame, no records at all, or random u32 words whose src wraps."""
    if case == "no_records":
        blocks = [(0, 10, False), (10, 6, True), (16, 0, False)]
        return (np.arange(16, dtype=np.uint8), blocks, [False, True],
                np.array([5, 6, 0], np.int64),
                [np.empty((0, 2), np.uint32)] * 3)
    if case == "random_words":
        rng = np.random.default_rng(43)
        blocks = [(0, 3000, False), (3000, 5, False), (3005, 900, False)]
        recs_l = [rng.integers(0, 1 << 32, (n, 2), dtype=np.uint32)
                  for n in (700, 0, 300)]
        return (rng.integers(0, 256, 3905, dtype=np.uint8), blocks,
                [False, True], np.array([1000, 0, 7], np.int64), recs_l)
    bs, indep, use_dict, stored, n = WORD_CASES[case]
    data = mixed_corpus(n, seed=44)
    if stored:
        rng = np.random.default_rng(42)
        data[: 300_000] = rng.integers(0, 256, 300_000, np.uint8)
    d = _dict(data) if use_dict else None
    frame = np.asarray(lz4.compress(data, dictionary=d, config=FrameConfig(
        block_size=bs, block_independence=indep, content_checksum=True)))
    header, blocks, _ = parse_block_index(frame)
    assert len(blocks) > 1
    assert any(st for _, _, st in blocks) == stored
    out_lens, recs_l = pt_wd.plan_blocks(
        frame, blocks, header, None if d is None else d[-65536:])
    return frame, blocks, [indep], out_lens, recs_l


@pytest.mark.parametrize("case", list(WORD_CASES) + ["no_records",
                                                     "random_words"])
def test_chain_words_match_numpy_packing(case):
    """The native pass packs the same five arrays as the numpy passes it
    replaced, byte for byte: src plus the block's offset in its chain's
    image, w1, and dst restarting at every chain (each block of an
    independent frame), all wrapping as u32."""
    buf, blocks, modes, out_lens, recs_l = _word_inputs(case)
    for independent in modes:
        want = _numpy_chain_arrays(buf, blocks, independent, out_lens, recs_l)
        got = pt_wd.build_chain_arrays(buf, blocks, independent, out_lens,
                                       recs_l)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("reach", ["output", "wire"])
def test_chain_arrays_refuse_u32_wrap(reach):
    """A linked chain whose output or compressed image reaches 4 GiB is
    refused before any array is built: its u32 dst or src would wrap."""
    half = pt_wd.U32 // 2
    if reach == "output":
        blocks, out_lens = [(0, 10, False)] * 2, [half, half]
    else:
        blocks, out_lens = [(0, half, False)] * 2, [10, 10]
    recs_l = [np.zeros((1, 2), np.int32)] * 2
    with pytest.raises(ValueError, match="4 GiB"):
        pt_wd.build_chain_arrays(np.zeros(16, np.uint8), blocks, False,
                                 np.array(out_lens, np.int64), recs_l)


@pytest.mark.parametrize("kind", ["giant_rle", "record_overflow"])
def test_frames_jax_declines_decode(kind):
    """The JAX wave planner returns None for these and falls back to its
    XLA kernels; the port decodes them itself."""
    if kind == "giant_rle":
        raw = np.zeros(MB + 1000, np.uint8)
    else:
        n_seq = 60_000
        raw = np.asarray(lz4.decompress_raw(np.frombuffer(
            _dense_sequence_block(n_seq), np.uint8), n_seq * 5 + 5))
    frame = np.asarray(lz4.compress(raw, config=FrameConfig(
        block_size=MB, block_independence=True)))
    header, blocks, _ = parse_block_index(frame)
    assert decompress_frame_waves(frame, blocks, header, None,
                                  interpret=True) is None
    out = pt.decompress_frame(frame, device="cpu")
    np.testing.assert_array_equal(out, raw)
    np.testing.assert_array_equal(
        out, np.asarray(device_decompress_frame(frame, engine="split")))


def _frame(blocks, block_size, independent):
    """A frame (no content size) around hand-built block streams."""
    cfg = FrameConfig(block_size=block_size,
                      block_independence=independent, content_size=False)
    parts = [_frame_header_bytes(cfg, 0)]
    for blk in blocks:
        parts.append(np.frombuffer(len(blk).to_bytes(4, "little"), np.uint8))
        parts.append(np.frombuffer(bytes(blk), np.uint8))
    parts.append(np.zeros(4, np.uint8))
    return np.concatenate(parts)


def _rle_block(out_len):
    """One literal 'a', an offset-1 match, five final literals."""
    ext = out_len - 6 - 4 - 15
    return (bytes([0x1F]) + b"a" + b"\x01\x00" + b"\xff" * (ext // 255)
            + bytes([ext % 255]) + b"\x50ABCDE")


def _hostile(kind):
    """(frame, dictionary) for one malformed linked or big-block frame."""
    valid = np.asarray(lz4.compress_raw(mixed_corpus(80_000, seed=43)))
    d = np.frombuffer(b"0123456789abcdef" * 16, np.uint8)   # 256 bytes
    if kind == "scan_truncated_run":
        return _frame([valid, b"\xf0\xff\xff"], MB, False), None
    if kind == "scan_zero_offset":
        return _frame([b"\x11a\x00\x00\x50ABCDE"], MB, True), None
    if kind == "over_block_max":
        return _frame([_rle_block(70_000)], 64 * KB, False), None
    if kind == "truncated_block":
        return _frame([valid[: len(valid) // 2]], 4 * MB, False), None
    if kind == "bad_offset":
        return _frame([b"\x10A\x02\x00\x50ABCDE"], 256 * KB, False), None
    # the first block reaches the dictionary's first byte; the second
    # reaches back through the first block to that byte, or one past it
    first = b"\x10A" + (1 + 256).to_bytes(2, "little") + b"\x50ABCDE"
    if kind == "reaches_dictionary":
        second = b"\x10B" + (1 + 10 + 256).to_bytes(2, "little") \
            + b"\x50VWXYZ"
        return _frame([first, second], 64 * KB, False), d
    assert kind == "past_dictionary"
    second = b"\x10B" + (1 + 10 + 257).to_bytes(2, "little") + b"\x50VWXYZ"
    return _frame([first, second], 64 * KB, False), d


HOSTILE = ["scan_truncated_run", "scan_zero_offset", "over_block_max",
           "truncated_block", "bad_offset", "past_dictionary"]


@pytest.mark.parametrize("kind", HOSTILE)
def test_errors_match_jax(kind):
    frame, dic = _hostile(kind)
    with pytest.raises(ValueError) as ref:
        device_decompress_frame(frame, dictionary=dic, engine="split")
    with pytest.raises(ValueError) as got:
        pt.decompress_frame(frame, dictionary=dic, device="cpu")
    assert str(got.value) == str(ref.value)
    assert str(got.value).startswith("LZ4: ")


def test_dictionary_reach_matches_jax():
    """A linked frame whose blocks reach back exactly as far as the
    dictionary and the earlier block allow decodes as in JAX."""
    frame, dic = _hostile("reaches_dictionary")
    out = pt.decompress_frame(frame, dictionary=dic, device="cpu")
    np.testing.assert_array_equal(out, np.asarray(device_decompress_frame(
        frame, dictionary=dic, engine="split")))
    assert out.tobytes() == b"A0123ABCDE" + b"B0123VWXYZ"


def _wire_entries(kind, rng, compressible):
    """(entries, plaintexts, window) for one wide-record batch."""
    if kind == "history":
        data = np.asarray(compressible(70_000))
        hist, plain = data[:30_000], data[30_000:]
        from divortio_lz4_tpu.ops.block_ref import compress_block_ref
        table = np.zeros(16384, np.int32)
        dst = np.zeros(len(data) * 2 + 1024, np.uint8)
        n = compress_block_ref(data, dst, len(hist), len(plain), table, 0)
        return [(dst[:n], False)], [plain], hist[-65536:]
    cases = _cases(rng, compressible)
    plains = [v for v in cases.values()
              if len(np.asarray(lz4.compress_raw(v))) < len(v)]
    entries = [(np.asarray(lz4.compress_raw(p)), False) for p in plains]
    stored = rng.integers(0, 256, 3000, np.uint8)
    return entries + [(stored, True)], plains + [stored], None


@pytest.mark.parametrize("kind", ["corpora", "history"])
def test_wire_decode_matches_jax(kind, rng, compressible):
    entries, plains, window = _wire_entries(kind, rng, compressible)
    bs = 256 * KB
    ref = jax_sd.parse_wire_batch(entries, bs, window)
    wire, recs, counts, out_lens, hist = pt_wr.parse_wire_batch(
        entries, bs, window)
    np.testing.assert_array_equal(wire, ref[0])
    np.testing.assert_array_equal(recs, ref[1][:, : recs.shape[1]])
    assert not ref[1][:, recs.shape[1]:].any()
    for a, b in zip((counts, out_lens, hist), ref[2:]):
        np.testing.assert_array_equal(a, b)
    import jax.numpy as jnp
    use_hist = hist is not None
    want = np.asarray(jax_sd.decode_blocks_wire(
        jnp.asarray(ref[0]), jnp.asarray(ref[1]), jnp.asarray(ref[2]), bs,
        use_hist, jnp.asarray(ref[4]) if use_hist else None, True, ways=1))
    got = pt_wr.decode_blocks_wire(
        *(torch.from_numpy(x) for x in ref[:3]), bs,
        torch.from_numpy(ref[4]) if use_hist else None).numpy()
    assert got.shape == (len(entries), bs)
    for i, p in enumerate(plains):
        n = int(out_lens[i])
        np.testing.assert_array_equal(got[i, :n], want[i, :n])
        np.testing.assert_array_equal(got[i, :n], p)
        assert not got[i, n:].any()   # zeros past out_len


def _jax_wire(entries, bs, window):
    """The JAX parse and interpret-mode wire decode of one batch: (port
    parse, JAX output rows)."""
    import jax.numpy as jnp
    ref = jax_sd.parse_wire_batch(entries, bs, window)
    use_hist = window is not None
    want = np.asarray(jax_sd.decode_blocks_wire(
        jnp.asarray(ref[0]), jnp.asarray(ref[1]), jnp.asarray(ref[2]), bs,
        use_hist, jnp.asarray(ref[4]) if use_hist else None, True, ways=1))
    return pt_wr.parse_wire_batch(entries, bs, window), want


def _stack_wire(parts):
    """One padded batch of several parse_wire_batch outputs (every part
    with a history row, or none)."""
    nb = sum(len(p[0]) for p in parts)
    wcap = max(p[0].shape[1] for p in parts)
    rcap = max(p[1].shape[1] for p in parts)
    wire = np.zeros((nb, wcap), np.uint8)
    recs = np.zeros((nb, rcap, 2), np.int32)
    at = 0
    for p in parts:
        n = len(p[0])
        wire[at: at + n, : p[0].shape[1]] = p[0]
        recs[at: at + n, : p[1].shape[1]] = p[1]
        at += n
    cat = [np.concatenate([p[i] for p in parts]) for i in (2, 3)]
    hist = None if parts[0][4] is None else \
        np.concatenate([p[4] for p in parts])
    return wire, recs, cat[0], cat[1], hist


def _wire_kind(kind, rng, compressible):
    """(padded batch, JAX output rows, the hostile block or None) of one
    resolved-wire case: "corpora" and "history" as above; "rows_differ",
    two blocks compressed against two different history windows in one
    batch; "hostile", the corpora batch with one block's records replaced
    by random words whose offsets are below 64 (matches that reach into
    themselves and offsets of 0), so it fails the conformance check."""
    bs = 256 * KB
    if kind in ("corpora", "history", "hostile"):
        entries, _, window = _wire_entries(
            "history" if kind == "history" else "corpora", rng,
            compressible)
        batch, want = _jax_wire(entries, bs, window)
    else:
        from divortio_lz4_tpu.ops.block_ref import compress_block_ref
        parts, wants = [], []
        for seed in (46, 47):
            data = mixed_corpus(90_000, seed)
            hist, plain = data[:40_000], data[40_000:]
            dst = np.zeros(2 * len(data) + 1024, np.uint8)
            n = compress_block_ref(data, dst, len(hist), len(plain),
                                   np.zeros(16384, np.int32), 0)
            batch, want = _jax_wire([(dst[:n], False)], bs, hist)
            parts.append(batch)
            wants.append(want)
        assert not np.array_equal(parts[0][4], parts[1][4])
        batch, want = _stack_wire(parts), np.concatenate(wants)
    h = None
    if kind == "hostile":
        wire, recs, counts, out_lens, hist = batch
        h = int(np.argmax(counts))
        n = int(counts[h])
        w = rng.integers(0, 2**32, (n, 2), dtype=np.uint64)
        w[:, 1] = (w[:, 1] & ~np.uint64(0xFFFF)) | (w[:, 1] & np.uint64(63))
        recs = recs.copy()
        recs[h, :n] = w.astype(np.uint32).view(np.int32)
        batch = (wire, recs, counts, out_lens, hist)
    return batch, want, h


@pytest.mark.parametrize("kind", ["corpora", "history", "rows_differ",
                                  "hostile"])
def test_wire_resolved_matches_plain_and_jax(kind, rng, compressible):
    """The parallel design's plain rendition on the padded form (dst scan,
    conformance, spans, pointer doubling with each block's own history
    row, the serial walk for the blocks that fail the check) equals
    decode_blocks_wire_plain and the JAX kernel."""
    (wire, recs, counts, out_lens, hist), want, h = _wire_kind(
        kind, rng, compressible)
    bs = 256 * KB
    args = [torch.from_numpy(x) for x in (wire, recs, counts)]
    th = None if hist is None else torch.from_numpy(hist)
    got, stats = pt_wr.decode_blocks_wire_resolved(*args, bs, th)
    plain = pt_wr.decode_blocks_wire_plain(*args, bs, th)
    assert torch.equal(got, plain)
    assert stats["serial_chains"] == (1 if kind == "hostile" else 0)
    assert stats["rounds"] and max(stats["rounds"]) >= 2
    for i in range(len(wire)):
        if i != h:
            n = int(out_lens[i])
            np.testing.assert_array_equal(got[i, :n].numpy(), want[i, :n])


def test_wire_chains_scan_each_block():
    """wire_chains: block b's records keep their words, their dst is the
    running sum of ll+ml inside the block, stored as at most block_size,
    and slots past counts[b] are dropped."""
    recs = torch.zeros((2, 4, 2), dtype=torch.int32)
    lm = [(3, 4), (0, 200), (255, 255), (9, 9)]
    for b in range(2):
        for k, (ll, ml) in enumerate(lm):
            recs[b, k, 0] = 10 * k + b
            recs[b, k, 1] = 5 | ll << 16 | (ml << 24 if ml < 128 else
                                            (ml << 24) - (1 << 32))
    wire = torch.zeros((2, 1024), dtype=torch.uint8)
    batch = pt_wr.wire_chains(wire, recs, torch.tensor([4, 2],
                                                       dtype=torch.int32),
                              512)
    assert batch.rec_off.tolist() == [0, 4, 6]
    assert batch.out_off.tolist() == [0, 512, 1024]
    assert batch.wire_off.tolist() == [0, 1024, 2048]
    w = batch.rec_words.to(torch.int64) & 0xFFFFFFFF
    assert w[:, 2].tolist() == [0, 7, 207, 512, 0, 7]
    assert w[:, 0].tolist() == [0, 10, 20, 30, 1, 11]


def _batch_for_hostile():
    frame, data, _ = _chain_frame("independent_1m")
    header, blocks, _ = parse_block_index(frame)
    return pt_wd.stage_chains(frame, blocks, header, None, "cpu"), data


def test_hostile_chain_stays_in_its_region():
    """Random words in chain 1's records: the plain version completes and
    the other chains decode exactly as without them."""
    batch, data = _batch_for_hostile()
    r0, r1 = int(batch.rec_off[1]), int(batch.rec_off[2])
    rng = np.random.default_rng(44)
    words = batch.rec_words.clone()
    words[r0:r1] = torch.from_numpy(rng.integers(
        -2**31, 2**31, (r1 - r0, 3), dtype=np.int64).astype(np.int32))
    out = pt_wd.decode_chains(batch._replace(rec_words=words)).numpy()
    o1, o2 = int(batch.out_off[1]), int(batch.out_off[2])
    np.testing.assert_array_equal(out[:o1], data[:o1])
    np.testing.assert_array_equal(out[o2:], data[o2:])


def test_decoders_reject_malformed_inputs():
    batch, _ = _batch_for_hostile()
    with pytest.raises(ValueError, match="wire"):
        pt_wd.decode_chains(batch._replace(wire=batch.wire.int()))
    with pytest.raises(ValueError, match="rec_off"):
        pt_wd.decode_chains(batch._replace(rec_off=batch.rec_off[:2]))
    with pytest.raises(ValueError, match="rec_words"):
        pt_wd.decode_chains(batch._replace(rec_words=batch.rec_words[:, :2]))
    with pytest.raises(ValueError, match="seed"):
        pt_wd.decode_chains(batch._replace(
            seed=torch.zeros(10, dtype=torch.uint8)))
    with pytest.raises(ValueError, match="out_total"):
        pt_wd.decode_chains(batch._replace(out_total=-1))
    wire = torch.zeros((2, 1024), dtype=torch.uint8)
    recs = torch.zeros((2, 1, 2), dtype=torch.int32)
    counts = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="recs"):
        pt_wr.decode_blocks_wire(wire, recs[:1], counts, 1024)
    with pytest.raises(ValueError, match="counts"):
        pt_wr.decode_blocks_wire(wire, recs, counts.long(), 1024)
    with pytest.raises(ValueError, match="block_size"):
        pt_wr.decode_blocks_wire(wire, recs, counts, 1000)
    out = pt_wr.decode_blocks_wire(wire, recs, counts, 1024)
    assert out.shape == (2, 1024) and not out.any()


def test_mixed_configurations_decode_in_one_call():
    """One decompress_frames call over 64 KB, 256 KB and 1 MB independent
    frames and a 4 MB linked frame with a dictionary: row outputs of two
    widths and a flat chain output share the single fetch."""
    data = mixed_corpus(250_000, seed=45)
    d = _dict(data)
    cfgs = [FrameConfig(block_size=64 * KB, block_independence=True),
            FrameConfig(block_size=256 * KB, block_independence=True),
            FrameConfig(block_size=MB, block_independence=True),
            FrameConfig(content_checksum=True)]
    frames = [np.asarray(lz4.compress(data[i * 30_000:], dictionary=d,
                                      config=c)) for i, c in enumerate(cfgs)]
    outs = pt.decompress_frames(frames, dictionary=d, device="cpu")
    for i, (f, o) in enumerate(zip(frames, outs)):
        np.testing.assert_array_equal(o, data[i * 30_000:])
        np.testing.assert_array_equal(o, np.asarray(device_decompress_frame(
            f, dictionary=d, engine="split")))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["linked_4m_dict", "independent_1m",
                                  "independent_256k_stored"])
def test_cuda_chain_kernel_matches_plain(case, cuda):
    frame, _, d = _chain_frame(case)
    header, blocks, _ = parse_block_index(frame)
    window = None if d is None else d[-65536:]
    batch = pt_wd.stage_chains(frame, blocks, header, window, cuda)
    want = pt_wd.decode_chains_plain(batch)
    before = pt_wd.decode_chains.launches
    got = pt_wd.decode_chains(batch)
    torch.cuda.synchronize()
    assert pt_wd.decode_chains.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["corpora", "history", "rows_differ",
                                  "hostile"])
def test_cuda_wire_kernel_matches_plain(kind, rng, compressible, cuda):
    (wire, recs, counts, _, hist), _, _ = _wire_kind(kind, rng,
                                                     compressible)
    args = [torch.from_numpy(x).to(cuda) for x in (wire, recs, counts)]
    h = None if hist is None else torch.from_numpy(hist).to(cuda)
    want = pt_wr.decode_blocks_wire_plain(*args, 256 * KB, h)
    before = pt_wr.decode_blocks_wire.launches
    got = pt_wr.decode_blocks_wire(*args, 256 * KB, h)
    torch.cuda.synchronize()
    assert pt_wr.decode_blocks_wire.launches == before + 1
    assert torch.equal(got, want)
    stats = pt_wr.decode_blocks_wire.last.stats()
    assert stats["serial_chains"] == (1 if kind == "hostile" else 0)


@pytest.mark.parametrize("case", ["linked_64k", "linked_256k_stored",
                                  "independent_1m"])
def test_record_spans_tile_the_output(case):
    """Stage A of the parallel design on parser-built chains: every chain
    conforms and its literal and match spans cover each output byte
    exactly once, in order."""
    frame, data, d = _chain_frame(case)
    header, blocks, _ = parse_block_index(frame)
    batch = pt_wd.stage_chains(frame, blocks, header,
                               None if d is None else d[-65536:], "cpu")
    conform, lits, matches = pt_wd.record_spans(batch)
    assert conform.all()
    cover = torch.zeros(batch.out_total, dtype=torch.int64)
    for at, n in ((lits.at, lits.n), (matches.at, matches.n)):
        owner = torch.repeat_interleave(torch.arange(len(n)), n)
        j = torch.arange(len(owner)) - (torch.cumsum(n, 0) - n)[owner]
        cover.index_add_(0, at[owner] + j, torch.ones_like(j))
    assert bool((cover == 1).all())
    # every match reads bytes before its record
    assert bool((matches.src + matches.n <= matches.at).all())
