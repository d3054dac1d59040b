"""The torch port's placed-literal split decode held against the JAX package
on the CPU.

The port's parse_records (the native lz4t_parse_records, copied into the
port's host library) must equal the JAX package's in records, literal
image, out_len and error strings; its plain decode_blocks_split (the CUDA
kernel's twin) must equal the JAX decode_blocks_split (its Pallas kernel
in interpret mode) on whole rows, garbage records included; and
decode_wire_blocks / decode_block_split_host must return the plaintext.
Tolerance: exact bytes everywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divortio_lz4_tpu as lz4
from _torch_port import cuda  # noqa: F401  (cuda: fixture)
from conftest import make_compressible
from divortio_lz4_tpu.ops import pallas_split_decode as jax_sd
from divortio_lz4_tpu.ops.block_ref import compress_block_ref
from divortio_lz4_tpu_torch.ops import split_decode as pt_sd

KB = 1024
W = 65536


def _cases():
    rng = np.random.default_rng(11)
    return {
        "text": np.frombuffer(b"the quick brown fox jumps! " * 600,
                              np.uint8),
        "rle": np.full(16000, 7, np.uint8),
        "period3": np.tile(np.array([1, 2, 3], np.uint8), 5000),
        "period200": np.tile(rng.integers(0, 256, 200, np.uint8), 80),
        "period130": np.tile(rng.integers(0, 256, 130, np.uint8), 120),
        "mixed": make_compressible(16000),
        "longlit": np.concatenate([rng.integers(0, 256, 500, np.uint8),
                                   np.full(300, 9, np.uint8),
                                   rng.integers(0, 256, 400, np.uint8)]),
    }


def _dict_block(n_hist=30000, n=16000):
    """(history, the block's wire bytes, its plaintext): a block whose
    matches reach back into a 30 KB history."""
    data = make_compressible(n_hist + n)
    dst = np.zeros(2 * len(data) + 1024, np.uint8)
    m = compress_block_ref(data, dst, n_hist, n, np.zeros(16384, np.int32),
                           0)
    return data[:n_hist], dst[:m], data[n_hist:]


@pytest.mark.parametrize("name", ["dictionary"] + sorted(_cases()))
def test_parse_records_matches_jax(name):
    if name == "dictionary":
        hist, comp, plain = _dict_block()
        dl = len(hist)
    else:
        plain, dl = _cases()[name], 0
        comp = np.asarray(lz4.compress_raw(plain))
    cap = len(plain) + 64
    lit_p, lit_j = np.zeros(cap, np.uint8), np.zeros(cap, np.uint8)
    rp, np_ = pt_sd.parse_records(comp, lit_p, cap, dl)
    rj, nj = jax_sd.parse_records(comp, lit_j, cap, dl)
    assert np_ == nj == len(plain)
    np.testing.assert_array_equal(rp, rj)
    np.testing.assert_array_equal(lit_p, lit_j)


BAD = {
    "truncated_run": bytes([0xF0] + [255] * 3),
    "offset0": bytes([0x10, ord("x"), 0x00, 0x00]),
    "overflow": bytes([0x4F, 1, 2, 3, 4, 0x01, 0x00, 250, 250, 250, 250, 0]),
    "lit_overrun": bytes([0xF0, 20, ord("x")]),
    "dict_oob": bytes([0x10, ord("x"), 0x08, 0x00, 0x10, ord("y")]),
}


@pytest.mark.parametrize("case", list(BAD))
def test_parse_records_errors_match_jax(case):
    src = np.frombuffer(BAD[case], np.uint8)
    with pytest.raises(ValueError) as want:
        jax_sd.parse_records(src, np.zeros(64, np.uint8), 64, 4)
    with pytest.raises(ValueError) as got:
        pt_sd.parse_records(src, np.zeros(64, np.uint8), 64, 4)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("LZ4: ")


def _jax_decode(lit, recs, counts, block_size, use_history):
    """The JAX kernel in interpret mode on rows in input order: padded with
    NOOP rows to its interleave width, each group's trip bound the max of
    its counts."""
    nb = len(lit)
    ways = jax_sd.plan_ways(recs.shape[1], lit.shape[1])
    pad = -nb % ways
    noop = np.empty((pad,) + recs.shape[1:], np.uint32)
    noop[..., 0] = jax_sd.NOOP_W0
    noop[..., 1] = jax_sd.NOOP_W1
    lit = np.concatenate([lit, np.zeros((pad, lit.shape[1]), np.uint8)])
    recs = np.concatenate([recs, noop.view(np.int32)])
    trips = jax_sd.grouped_trips(np.concatenate(
        [counts, np.zeros(pad, np.int32)]), ways)
    out = jax_sd.decode_blocks_split(jnp.asarray(lit), jnp.asarray(recs),
                                     jnp.asarray(trips), block_size,
                                     use_history, True)
    return np.asarray(out).astype(np.uint8)[:nb]


def _batch(case):
    """(lit, recs, counts, block_size, use_history, plaintexts or None)."""
    rng = np.random.default_rng(12)
    if case == "sorted_blocks":
        blocks = [make_compressible(8 * KB) for _ in range(3)]
        blocks += [np.full(8 * KB, 3, np.uint8),
                   np.tile(rng.integers(0, 256, 100, np.uint8), 82)[:8 * KB],
                   np.frombuffer(b"tiny!", np.uint8)]
        comps = [np.asarray(lz4.compress_raw(b)) for b in blocks]
        lit, recs, counts, _, uh = pt_sd.parse_block_batch(comps, 8 * KB)
        return lit, recs, counts, 8 * KB, uh, blocks
    if case == "history":
        hist, comp, plain = _dict_block()
        comps = [comp, np.asarray(lz4.compress_raw(plain[:5000]))]
        lit, recs, counts, _, uh = pt_sd.parse_block_batch(
            comps, 16 * KB, [hist, None])
        return lit, recs, counts, 16 * KB, uh, [plain, plain[:5000]]
    bs = 2 * KB
    io_bytes = -(-(bs + 256) // 1024) * 1024
    if case == "garbage":
        lit = np.zeros((2, io_bytes), np.uint8)
        lit[:, :bs] = 7
        lit[1, :bs] = rng.integers(0, 256, bs, dtype=np.uint8)
        recs = rng.integers(0, 2**32, (2, 128, 2), dtype=np.int64) \
            .astype(np.uint32)
        recs[:, ::3, 0] = 0            # zero offsets and zero lengths
        recs[1, 1::5, 1] |= 0x80000000  # negative dst words
        return lit, recs.view(np.int32), np.full(2, 128, np.int32), bs, \
            False, None
    lit = (np.arange(2 * io_bytes) % 256).astype(np.uint8).reshape(2, -1)
    recs = np.empty((2, 128, 2), np.int32)
    recs[..., 0] = pt_sd.NOOP_W0
    recs[..., 1] = pt_sd.NOOP_W1
    return lit, recs, np.full(2, 128, np.int32), bs, False, None


@pytest.mark.parametrize("case", ["sorted_blocks", "history", "garbage",
                                  "noop_identity"])
def test_plain_decode_matches_jax_kernel(case):
    lit, recs, counts, bs, uh, plains = _batch(case)
    got = pt_sd.decode_blocks_split(torch.from_numpy(lit),
                                    torch.from_numpy(recs),
                                    torch.from_numpy(counts), bs, uh)
    assert got.dtype == torch.uint8 and got.shape == (len(lit), bs)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_decode(lit, recs, counts, bs, uh))
    if case == "noop_identity":
        np.testing.assert_array_equal(got.numpy(), lit[:, :bs])
    for i, p in enumerate(plains or []):
        np.testing.assert_array_equal(got[i, : len(p)].numpy(), p)


def test_wire_blocks_and_host_wrapper_return_plaintext():
    blocks = [make_compressible(16 * KB), np.full(9000, 1, np.uint8),
              np.frombuffer(b"abc", np.uint8), np.zeros(0, np.uint8)]
    comps = [np.asarray(lz4.compress_raw(b)) for b in blocks]
    outs = pt_sd.decode_wire_blocks(comps, 16 * KB, device="cpu")
    assert [o.tobytes() for o in outs] == [b.tobytes() for b in blocks]
    for c, b in zip(comps, blocks):
        np.testing.assert_array_equal(
            pt_sd.decode_block_split_host(c, max(len(b), 1), device="cpu"), b)
    hist, comp, plain = _dict_block()
    np.testing.assert_array_equal(
        pt_sd.decode_block_split_host(comp, W, history=hist, device="cpu"),
        plain)
    np.testing.assert_array_equal(
        pt_sd.decode_block_split_host(comp, W, history=hist, device="cpu"),
        np.asarray(jax_sd.decode_block_split_host(comp, W, history=hist)))


def test_wrapper_checks_inputs():
    lit = torch.zeros((1, 1024), dtype=torch.uint8)
    recs = torch.zeros((1, 128, 2), dtype=torch.int32)
    counts = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="do not hold"):
        pt_sd.decode_blocks_split(lit, recs, counts, 2048)
    with pytest.raises(ValueError, match="do not hold"):
        pt_sd.decode_blocks_split(lit, recs, counts, 512, use_history=True)
    with pytest.raises(ValueError, match="counts"):
        pt_sd.decode_blocks_split(lit, recs, counts.long(), 512)
    with pytest.raises(ValueError, match="lit holds"):
        pt_sd.parse_records(np.zeros(4, np.uint8), np.zeros(8, np.uint8), 64)


@pytest.mark.parametrize("case", ["sorted_blocks", "history", "garbage",
                                  "noop_identity"])
def test_grouped_rendition_matches_plain_and_jax(case):
    """The kernel's algorithm (conformance, levels) gives the serial plain
    version's and the JAX kernel's bytes; the parser's blocks take the
    grouped route, the garbage rows the serial one."""
    lit, recs, counts, bs, uh, plains = _batch(case)
    args = [torch.from_numpy(a) for a in (lit, recs, counts)]
    got, stats = pt_sd.decode_blocks_split_grouped_plain(*args, bs, uh)
    assert torch.equal(got, pt_sd.decode_blocks_split_plain(*args, bs, uh))
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_decode(lit, recs, counts, bs, uh))
    for i, p in enumerate(plains or []):
        np.testing.assert_array_equal(got[i, : len(p)].numpy(), p)
    st = stats.numpy()
    np.testing.assert_array_equal(st[:, 0], counts)
    assert st[:, 4].tolist() == [int(case == "garbage")] * len(lit)
    if case != "garbage":
        np.testing.assert_array_equal(st[:, 1], -(-counts // 32))


@pytest.mark.parametrize("name", ["dictionary"] + sorted(_cases()))
def test_parser_records_conform(name):
    """Every record lz4t_parse_records emits passes the conformance check
    (doubling chains and 128-byte splits included)."""
    if name == "dictionary":
        hist, comp, plain = _dict_block()
        batch = pt_sd.parse_block_batch([comp], len(plain), [hist])
    else:
        plain = _cases()[name]
        batch = pt_sd.parse_block_batch([np.asarray(lz4.compress_raw(plain))],
                                        len(plain))
    lit, recs, counts, _, uh = batch
    got, stats = pt_sd.decode_blocks_split_grouped_plain(
        *(torch.from_numpy(a) for a in (lit, recs, counts)), len(plain), uh)
    assert stats[0, 4] == 0
    np.testing.assert_array_equal(got[0].numpy(), plain)


# one one-record mutation a conformance rule
RULES = ("dst_negative", "dst_past_cap", "dst_zero", "offset0",
         "offset_past_dst", "span", "room", "overlap", "order")


def _mutated(rule):
    """A parser-built batch (block 0 fills its 8 KB, block 1 holds 6000
    bytes; with a history window for "dst_negative", so that a negative
    dst still lies in the io row) with one record of one block changed to
    break *rule*. Returns (lit, recs, counts, block_size, use_history, the
    changed block)."""
    bs = 8 * KB
    blocks = [make_compressible(bs), make_compressible(6000)]
    hists = [make_compressible(1000)] * 2 if rule == "dst_negative" else None
    lit, recs, counts, _, uh = pt_sd.parse_block_batch(
        [np.asarray(lz4.compress_raw(b)) for b in blocks], bs, hists)
    recs = recs.copy()
    b = 0 if rule == "room" else 1
    r = recs[b, : counts[b]]            # a view: changes land in recs
    offset, mlen, dst = r[:, 0] & 0xFFFF, (r[:, 0] >> 16) & 0xFFFF, r[:, 1]
    k = int(np.flatnonzero((mlen >= 2) & (dst >= 200))[0])
    last = int(np.flatnonzero(mlen > 0)[-1])
    if rule == "dst_negative":
        r[0, 1] = -1
    elif rule == "dst_past_cap":
        r[last, 1] = bs + 1
    elif rule == "dst_zero":
        r[0, 1] = 0
    elif rule == "offset0":
        r[k, 0] = mlen[k] << 16
    elif rule == "offset_past_dst":
        r[0, 0] = (mlen[0] << 16) | (dst[0] + 1)
    elif rule == "span":
        assert dst[last] + 129 <= bs
        r[last, 0] = (129 << 16) | dst[last]
    elif rule == "room":
        r[last, 1] = bs - mlen[last] + 1
    elif rule == "overlap":
        r[k, 0] = (mlen[k] << 16) | (mlen[k] - 1)
    else:
        r[[k - 1, k]] = r[[k, k - 1]]
    return lit, recs, counts, bs, uh, b


@pytest.mark.parametrize("rule", RULES)
def test_conformance_mutation_routes_its_block_serially(rule):
    """Each rule of the check, broken by one record of one block: exactly
    that block takes the serial route, and the bytes stay the serial
    plain version's."""
    lit, recs, counts, bs, uh, b = _mutated(rule)
    args = [torch.from_numpy(a) for a in (lit, recs, counts)]
    got, stats = pt_sd.decode_blocks_split_grouped_plain(*args, bs, uh)
    assert stats[:, 4].tolist() == [int(i == b) for i in range(2)]
    assert torch.equal(got, pt_sd.decode_blocks_split_plain(*args, bs, uh))


@pytest.mark.parametrize("tail,levels,text", [
    ([(12, 4, 12)], 1, b"abcdefghabcdabcd"),    # source before the group
    ([(10, 4, 12)], 1, b"abcdefghabcdcdef"),    # literals only
    ([(4, 4, 12)], 2, b"abcdefghabcdabcd"),     # record 0's output
    ([(6, 4, 12)], 2, b"abcdefghabcdghab"),     # part of it
    ([(4, 4, 12), (4, 4, 16)], 3, b"abcdefghabcdabcdabcd"),   # a chain
])
def test_levels_pinned_on_a_hand_built_row(tail, levels, text):
    """A 64-byte block whose literal image starts "abcdefgh"; record 0
    copies 4 of its bytes to 8; the (offset, mlen, dst) records after it
    set the level count."""
    lit = np.zeros((1, 1024), np.uint8)
    lit[0, :8] = np.frombuffer(b"abcdefgh", np.uint8)
    recs = np.empty((1, 128, 2), np.int32)
    recs[..., 0], recs[..., 1] = pt_sd.NOOP_W0, pt_sd.NOOP_W1
    for i, (o, n, d) in enumerate([(8, 4, 8)] + tail):
        recs[0, i] = (o | n << 16, d)
    args = [torch.from_numpy(a) for a in
            (lit, recs, np.array([1 + len(tail)], np.int32))]
    got, stats = pt_sd.decode_blocks_split_grouped_plain(*args, 64)
    assert bytes(got[0, : len(text)].tolist()) == text
    assert torch.equal(got, pt_sd.decode_blocks_split_plain(*args, 64))
    assert stats[0].tolist() == [1 + len(tail), 1, levels, levels, 0]


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda):
    """The kernel against its plain version on every batch above, every
    conformance mutation and 256 KB blocks with a history (rows past the
    shared-memory limit), its stats against the grouped rendition's;
    launches goes up by one per call."""
    blocks = [make_compressible(256 * KB), np.full(200_000, 5, np.uint8)]
    comps = [np.asarray(lz4.compress_raw(b)) for b in blocks]
    big = pt_sd.parse_block_batch(comps, 256 * KB, [make_compressible(W)] * 2)
    batches = [_batch(c)[:5] for c in ("sorted_blocks", "history", "garbage",
                                       "noop_identity")]
    batches += [_mutated(r)[:5] for r in RULES]
    batches.append(big[:3] + (256 * KB, big[4]))
    for lit, recs, counts, bs, uh in batches:
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
                for a in (lit, recs, counts)]
        want = pt_sd.decode_blocks_split_plain(*args, bs, uh)
        _, want_stats = pt_sd.decode_blocks_split_grouped_plain(
            *(a.cpu() for a in args), bs, uh)
        before = pt_sd.decode_blocks_split.launches
        got = pt_sd.decode_blocks_split(*args, bs, uh)
        assert pt_sd.decode_blocks_split.launches == before + 1
        torch.testing.assert_close(got.cpu(), want.cpu(), rtol=0, atol=0)
        assert torch.equal(pt_sd.decode_blocks_split.last_stats.cpu().long(),
                           want_stats)
