"""The torch port's compact decode held against the JAX package on the CPU.

Both decoders get the same parsed records: the tuple of parse_wire_raw.
The JAX side runs its Pallas compact kernel (decode_blocks_wire_compact,
through dispatch_compact) in interpret mode; the port runs
decode_blocks_compact, whose CPU path is the plain PyTorch version.
Tolerance: exact over [0, out_len) of every block (the TPU kernel leaves
garbage past out_len; the port writes zeros there).
"""

import numpy as np
import pytest
import torch

import divortio_lz4_tpu as lz4
from _torch_port import cuda  # noqa: F401  (fixture)
from conftest import make_compressible
from divortio_lz4_tpu.ops import pallas_split_decode as jax_sd
from divortio_lz4_tpu_torch.ops import compact_decode as pt_cd
from divortio_lz4_tpu_torch.ops import split_decode as pt_sd
from test_compact_decode import _mixed_blocks


def _entries(kind):
    """(entries, plaintexts, block_size, window) for one batch kind."""
    rng = np.random.default_rng(17)
    if kind == "mixed":
        bs = 16384
        blocks = _mixed_blocks(bs, nb=10)
        return [(np.asarray(lz4.compress_raw(p)), False)
                for p in blocks], blocks, bs, None
    if kind == "stored":
        bs = 65536
        blocks = [rng.integers(0, 256, n).astype(np.uint8)
                  for n in (65536, 1000, 129, 128, 1)]
        return [(p, True) for p in blocks], blocks, bs, None
    if kind == "dense":
        bs = 65536
        blocks = [rng.integers(0, 4, bs).astype(np.uint8) for _ in range(2)]
        return [(np.asarray(lz4.compress_raw(p)), False)
                for p in blocks], blocks, bs, None
    if kind == "dict_rows":
        # every block starts inside the dictionary: block b's first match
        # reads its own history row
        bs = 65536
        d = rng.integers(0, 256, 20000).astype(np.uint8)
        blocks = [np.resize(np.roll(d, 997 * (b + 1)), bs) for b in range(4)]
        from divortio_lz4_tpu.config import FrameConfig
        from divortio_lz4_tpu_torch.parallel.device import parse_block_index
        frame = np.asarray(lz4.compress(
            np.concatenate(blocks), dictionary=d, config=FrameConfig(
                block_size=bs, block_independence=True)))
        _, index, _ = parse_block_index(frame)
        return [(frame[o: o + s], st) for o, s, st in index], blocks, bs, d
    assert kind == "dict"
    bs = 16384
    plain = np.concatenate(_mixed_blocks(bs, nb=6, seed=9))
    d = plain[:9000].copy()
    from divortio_lz4_tpu.config import FrameConfig
    from divortio_lz4_tpu_torch.parallel.device import parse_block_index
    frame = np.asarray(lz4.compress(plain, dictionary=d, config=FrameConfig(
        block_size=65536, block_independence=True)))
    _, blocks, _ = parse_block_index(frame)
    entries = [(frame[o: o + s], st) for o, s, st in blocks]
    outs = [plain[i * 65536: (i + 1) * 65536] for i in range(len(blocks))]
    return entries, outs, 65536, d


def _jax_rows(entries, wire, recs_l, counts, out_lens, bs, hist):
    wire_w = np.array([len(c) for c, _ in entries])
    pend = jax_sd.dispatch_compact(wire, recs_l, counts, out_lens,
                                   wire_w, bs, True, hist=hist)
    rows = [None] * len(recs_l)
    for sel_p, out in pend:
        o = np.asarray(out)
        for k, b in enumerate(sel_p):
            if rows[b] is None:
                rows[b] = o[k][: int(out_lens[b])]
    return rows


@pytest.mark.parametrize("kind", ["mixed", "stored", "dense", "dict"])
def test_plain_decode_matches_jax_compact_kernel(kind):
    entries, plains, bs, window = _entries(kind)
    ref = jax_sd.parse_wire_raw(entries, bs, window)
    port = pt_sd.parse_wire_raw(entries, bs, window)
    for a, b in zip(ref, port):
        if isinstance(a, list):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        elif a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)
    wire, recs_l, counts, out_lens, hist = ref
    want = _jax_rows(entries, wire, recs_l, counts, out_lens, bs, hist)
    batch = pt_sd.from_reference_records(wire, recs_l, out_lens, hist,
                                         "cpu")
    got = pt_cd.decode_blocks_compact(batch.wire, batch.rec_words,
                                      batch.rec_off, batch.out_lens, bs,
                                      batch.hist).numpy()
    assert got.shape == (len(entries), bs)
    for i, p in enumerate(plains):
        n = int(out_lens[i])
        np.testing.assert_array_equal(got[i, :n], want[i])
        np.testing.assert_array_equal(got[i, :n], p)
        assert not got[i, n:].any()  # zeros past out_len


def test_flat_records_match_reference_packing():
    """The CSR builder packs exactly build_compact_batch's words (pad
    records aside): same (src|ll<<16|ml<<24, dst|off<<16) per record."""
    entries, _, bs, _ = _entries("mixed")
    _, recs_l, counts, _, _ = jax_sd.parse_wire_raw(entries, bs)
    order = np.arange(len(recs_l))
    words, bases, _ = jax_sd.build_compact_batch(recs_l, counts, order, 1,
                                                 1, bs)
    rec_words, rec_off = pt_sd.build_flat_records(recs_l)
    np.testing.assert_array_equal(np.diff(rec_off), counts)
    for b in range(len(recs_l)):
        ref = words[bases[b]: bases[b] + 2 * counts[b]].reshape(-1, 2)
        np.testing.assert_array_equal(
            rec_words[rec_off[b]: rec_off[b + 1]], ref)


def test_hostile_records_stay_in_their_row():
    """Random words in one row's records: the plain version completes, the
    other rows decode exactly as without them."""
    entries, plains, bs, _ = _entries("mixed")
    wire, recs_l, _, out_lens, _ = pt_sd.parse_wire_raw(entries, bs)
    batch = pt_sd.from_reference_records(wire, recs_l, out_lens, None,
                                         "cpu")
    r0, r1 = int(batch.rec_off[3]), int(batch.rec_off[4])
    rng = np.random.default_rng(11)
    words = batch.rec_words.clone()
    words[r0:r1] = torch.from_numpy(rng.integers(
        -2**31, 2**31, (r1 - r0, 2), dtype=np.int64).astype(np.int32))
    out = pt_cd.decode_blocks_compact(batch.wire, words, batch.rec_off,
                                      batch.out_lens, bs).numpy()
    assert out.shape == (len(entries), bs)
    for i, p in enumerate(plains):
        if i != 3:
            np.testing.assert_array_equal(out[i, : len(p)], p)


def test_decode_rejects_malformed_inputs():
    wire = torch.zeros((2, 1024), dtype=torch.uint8)
    words = torch.zeros((0, 2), dtype=torch.int32)
    off = torch.zeros(3, dtype=torch.int64)
    lens = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="wire"):
        pt_cd.decode_blocks_compact(wire.int(), words, off, lens, 1024)
    with pytest.raises(ValueError, match="rec_off"):
        pt_cd.decode_blocks_compact(wire, words, off[:2], lens, 1024)
    with pytest.raises(ValueError, match="block_size"):
        pt_cd.decode_blocks_compact(wire, words, off, lens, 1000)
    with pytest.raises(ValueError, match="hist"):
        pt_cd.decode_blocks_compact(wire, words, off, lens, 1024,
                                    torch.zeros((2, 10), dtype=torch.uint8))
    out = pt_cd.decode_blocks_compact(wire, words, off, lens, 1024)
    assert out.shape == (2, 1024) and not out.any()


def test_parse_errors_match_reference():
    """Malformed block bytes raise the host error taxonomy, unchanged."""
    bad = np.frombuffer(bytes([0xF0]) + b"\xff" * 4, np.uint8)
    with pytest.raises(ValueError) as ref:
        jax_sd.parse_records_wire(bad, 65536)
    with pytest.raises(ValueError) as got:
        pt_sd.parse_records_wire(bad, 65536)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("kind", ["mixed", "stored", "dense", "dict",
                                  "dict_rows"])
def test_grouped_rendition_matches_plain_and_jax(kind):
    """The kernel's algorithm (conformance, literals, levels) gives the
    serial plain version's and the JAX kernel's bytes; every block the
    parser built takes the grouped route."""
    entries, plains, bs, window = _entries(kind)
    wire, recs_l, counts, out_lens, hist = jax_sd.parse_wire_raw(
        entries, bs, window)
    want = _jax_rows(entries, wire, recs_l, counts, out_lens, bs, hist)
    batch = pt_sd.from_reference_records(wire, recs_l, out_lens, hist,
                                         "cpu")
    args = (*batch[:4], bs, batch.hist)
    got, stats = pt_cd.decode_blocks_compact_grouped_plain(*args)
    assert torch.equal(got, pt_cd.decode_blocks_compact_plain(*args))
    for i, p in enumerate(plains):
        n = int(out_lens[i])
        np.testing.assert_array_equal(got[i, :n].numpy(), want[i])
        np.testing.assert_array_equal(got[i, :n].numpy(), p)
    st = stats.numpy()
    np.testing.assert_array_equal(st[:, 0], counts)
    np.testing.assert_array_equal(st[:, 1], -(-counts // 32))
    assert not st[:, 4].any()
    assert (st[:, 3] <= 32).all() and (st[:, 2] >= st[:, 3]).all()


def _parser_payloads():
    rng = np.random.default_rng(23)
    return {
        "text": np.frombuffer(b"the quick brown fox jumps! " * 600,
                              np.uint8),
        "rle": np.full(16000, 7, np.uint8),
        "period3": np.tile(np.array([1, 2, 3], np.uint8), 5000),
        "period130": np.tile(rng.integers(0, 256, 130, np.uint8), 120),
        "period200": np.tile(rng.integers(0, 256, 200, np.uint8), 80),
        "longlit": np.concatenate([rng.integers(0, 256, 700, np.uint8),
                                   np.full(300, 9, np.uint8),
                                   rng.integers(0, 256, 400, np.uint8)]),
        "compressible": make_compressible(16000),
    }


@pytest.mark.parametrize("name", sorted(_parser_payloads()))
def test_parser_records_conform(name):
    """Every record lz4t_parse_records2 emits passes the conformance
    check (long literals, RLE and doubling chains, 128-byte splits of
    matches with offsets 128-255 included)."""
    p = _parser_payloads()[name]
    bs = 16384
    blocks = [p[i: i + bs] for i in range(0, len(p), bs)]
    entries = [(np.asarray(lz4.compress_raw(b)), False) for b in blocks]
    wire, recs_l, counts, out_lens, _ = pt_sd.parse_wire_raw(entries, bs)
    batch = pt_sd.from_reference_records(wire, recs_l, out_lens, None,
                                         "cpu")
    got, stats = pt_cd.decode_blocks_compact_grouped_plain(*batch[:4], bs)
    assert not stats[:, 4].any()
    for i, b in enumerate(blocks):
        np.testing.assert_array_equal(got[i, : len(b)].numpy(), b)


# one one-record mutation a conformance rule: (block, pick a record, set)
RULES = ("dst_clamp", "span", "end", "src", "off0", "running_sum",
         "overlap", "history")


def _mutated(rule):
    """A parser-built batch (block 0 fills its 16 KB, block 1 holds 12000
    bytes) with one record of one block changed to break *rule*. Returns
    (batch, block_size, the changed block)."""
    bs = 16384
    blocks = [make_compressible(bs), make_compressible(12000)]
    entries = [(np.asarray(lz4.compress_raw(b)), False) for b in blocks]
    wire, recs_l, _, out_lens, _ = pt_sd.parse_wire_raw(entries, bs)
    batch = pt_sd.from_reference_records(wire, recs_l, out_lens, None,
                                         "cpu")
    words = batch.rec_words.numpy().view(np.uint32).copy()
    off = batch.rec_off.numpy()
    b = 0 if rule == "end" else 1
    r = words[off[b]: off[b + 1]]        # a view: changes land in words
    src, ll, ml = r[:, 0] & 0xFFFF, (r[:, 0] >> 16) & 0xFF, r[:, 0] >> 24
    dst, roff = r[:, 1] & 0xFFFF, r[:, 1] >> 16

    def put(k, src_=None, ll_=None, ml_=None, dst_=None, off_=None):
        f = [int(x[k]) if v is None else v for x, v in
             ((src, src_), (ll, ll_), (ml, ml_), (dst, dst_), (roff, off_))]
        r[k] = (f[0] | f[1] << 16 | f[2] << 24, f[3] | f[4] << 16)

    last = len(r) - 1
    far = int(np.flatnonzero((ml > 0) & (dst >= 128))[0])
    if rule == "dst_clamp":
        put(last, dst_=bs + 1)
    elif rule == "span":
        assert ml[last] == 0
        put(last, ll_=129)
    elif rule == "end":
        assert dst[last] + ll[last] + ml[last] == bs and ll[last] < 128
        put(last, ll_=int(ll[last]) + 1)
    elif rule == "src":
        put(int(np.flatnonzero(ll > 0)[0]), src_=wire.shape[1] - 255)
    elif rule == "off0":
        assert ml[last] == 0 and ll[last] > 0
        put(last, off_=0)
    elif rule == "running_sum":
        put(far, dst_=int(dst[far]) + 1)
    elif rule == "overlap":
        put(far, off_=int(ll[far] + ml[far]) - 1)
    else:
        put(far, off_=int(dst[far] + ll[far]) + 1)
    words = torch.from_numpy(words.view(np.int32))
    return batch._replace(rec_words=words), bs, b


@pytest.mark.parametrize("rule", RULES)
def test_conformance_mutation_routes_its_block_serially(rule):
    """Each rule of the check, broken by one record of one block: exactly
    that block takes the serial route, and the bytes stay the serial
    plain version's."""
    batch, bs, b = _mutated(rule)
    args = (*batch[:4], bs, batch.hist)
    got, stats = pt_cd.decode_blocks_compact_grouped_plain(*args)
    assert stats[:, 4].tolist() == [int(i == b) for i in range(2)]
    assert torch.equal(got, pt_cd.decode_blocks_compact_plain(*args))


def _row(recs):
    """One block of 64 bytes whose wire row starts "abcdefgh"; *recs* are
    (src, ll, ml, dst, off) tuples."""
    wire = torch.zeros((1, 1024), dtype=torch.uint8)
    wire[0, :8] = torch.tensor(list(b"abcdefgh"), dtype=torch.uint8)
    words = np.array([(s | ll << 16 | ml << 24, d | o << 16)
                      for s, ll, ml, d, o in recs], np.uint32)
    return (wire, torch.from_numpy(words.view(np.int32)),
            torch.tensor([0, len(recs)]), torch.tensor([64]))


@pytest.mark.parametrize("tail,levels,text", [
    ([(0, 0, 4, 12, 12)], 1, b"abcdefghabcdabcd"),    # source before
    ([(0, 0, 4, 12, 10)], 1, b"abcdefghabcdcdef"),    # literals only
    ([(0, 0, 4, 12, 4)], 2, b"abcdefghabcdabcd"),     # rec 1's output
    ([(0, 0, 4, 12, 6)], 2, b"abcdefghabcdghab"),     # part of it
    ([(0, 0, 4, 12, 4), (0, 0, 4, 16, 4)], 3,
     b"abcdefghabcdabcdabcd"),                         # a chain of three
])
def test_levels_pinned_on_a_hand_built_row(tail, levels, text):
    """Record 0 places 8 literals, record 1 copies 4 of them to 8; the
    records after it set the level count."""
    args = _row([(0, 8, 0, 0, 1), (0, 0, 4, 8, 8)] + tail) + (64,)
    got, stats = pt_cd.decode_blocks_compact_grouped_plain(*args)
    assert bytes(got[0, : len(text)].tolist()) == text
    assert torch.equal(got, pt_cd.decode_blocks_compact_plain(*args))
    assert stats[0].tolist() == [2 + len(tail), 1, levels, levels, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mixed", "stored", "dense", "dict",
                                  "dict_rows"]
                         + [f"mutated_{r}" for r in RULES])
def test_cuda_kernel_matches_plain(kind, cuda):
    """The kernel against its plain version, byte for byte, and its stats
    against the grouped rendition's, on every batch and every conformance
    mutation."""
    if kind.startswith("mutated_"):
        cpu, bs, _ = _mutated(kind[len("mutated_"):])
        gpu = pt_sd.CompactBatch(*(None if x is None else x.to(cuda)
                                   for x in cpu))
    else:
        entries, _, bs, window = _entries(kind)
        wire, recs_l, _, out_lens, hist = pt_sd.parse_wire_raw(entries, bs,
                                                               window)
        cpu = pt_sd.from_reference_records(wire, recs_l, out_lens, hist,
                                           "cpu")
        gpu = pt_sd.from_reference_records(wire, recs_l, out_lens, hist,
                                           cuda)
    want = pt_cd.decode_blocks_compact(*cpu[:4], bs, cpu.hist)
    _, want_stats = pt_cd.decode_blocks_compact_grouped_plain(*cpu[:4], bs,
                                                              cpu.hist)
    before = pt_cd.decode_blocks_compact.launches
    got = pt_cd.decode_blocks_compact(*gpu[:4], bs, gpu.hist)
    torch.cuda.synchronize()
    assert pt_cd.decode_blocks_compact.launches == before + 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(pt_cd.decode_blocks_compact.last_stats.cpu().long(),
                       want_stats)
