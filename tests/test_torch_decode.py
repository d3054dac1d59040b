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


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mixed", "stored", "dense", "dict"])
def test_cuda_kernel_matches_plain(kind, cuda):
    entries, _, bs, window = _entries(kind)
    wire, recs_l, _, out_lens, hist = pt_sd.parse_wire_raw(entries, bs,
                                                           window)
    cpu = pt_sd.from_reference_records(wire, recs_l, out_lens, hist, "cpu")
    gpu = pt_sd.from_reference_records(wire, recs_l, out_lens, hist, cuda)
    want = pt_cd.decode_blocks_compact(*cpu[:4], bs, cpu.hist)
    before = pt_cd.decode_blocks_compact.launches
    got = pt_cd.decode_blocks_compact(*gpu[:4], bs, gpu.hist)
    torch.cuda.synchronize()
    assert pt_cd.decode_blocks_compact.launches == before + 1
    assert torch.equal(got.cpu(), want)
