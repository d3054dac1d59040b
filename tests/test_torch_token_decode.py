"""The torch port's token-parsing decoder (engine="pallas") held against the
JAX package on the CPU.

The port's plain decode_blocks_pallas must equal the JAX
decode_blocks_pallas (its Pallas kernel in interpret mode) on valid blocks,
on blocks that reach into a dictionary history, and on hostile blocks of
random bytes (tests/test_fuzz.py:117); decode_linked_chunk must equal the
JAX decode_linked_chunk_pallas. decompress_frame(engine="pallas") must
give the bytes, or the "LZ4: ..." error, of the JAX
device_decompress_frame(engine="pallas") on every route: independent rows,
the scan route (1 MB and linked 4 MB blocks), linked frames with a
dictionary, broken streams and mutated frames. Tolerance: exact bytes
everywhere; rows are compared over [0, out_len), where the TPU kernel
leaves wild writes past it and the port zeros.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divortio_lz4_tpu as lz4
import divortio_lz4_tpu_torch as pt
from _torch_port import REC, cuda  # noqa: F401  (cuda: fixture)
from divortio_lz4_tpu.backends import get_backend
from divortio_lz4_tpu.config import FrameConfig
from divortio_lz4_tpu.constants import block_bound
from divortio_lz4_tpu.ops import pallas_decode as jax_pd
from divortio_lz4_tpu.ops.block_ref import new_hash_table
from divortio_lz4_tpu.parallel.device import device_decompress_frame
from divortio_lz4_tpu_torch.ops import token_decode as pt_td
from divortio_lz4_tpu_torch.parallel import device as pt_dev
from test_pallas_decode import CASES

KB, MB, W = 1024, 1048576, 65536


def _records(n: int) -> np.ndarray:
    return np.frombuffer(b"".join(REC % (i * 7919 % 1000)
                                  for i in range(n // 40 + 1)), np.uint8)[:n]


def _with_history(data, hist) -> np.ndarray:
    """One block compressed against *hist* (the host encoder with a warmed
    table), so its matches reach back into the history."""
    be = get_backend()
    combined = np.concatenate([hist, data])
    table = new_hash_table()
    be.warm_table(table, combined, len(hist))
    out = np.empty(block_bound(len(data)), np.uint8)
    n = be.compress_block(combined, out, len(hist), len(data), table, 0)
    return out[:n]


def _block_batch(kind: str, rng):
    """(compressed rows, history or None, capacity) of one batch."""
    if kind == "hostile":
        # tests/test_fuzz.py:117: 8 rows of 1-191 random bytes, 2 KB out
        return [rng.integers(0, 256, int(rng.integers(1, 192)),
                             dtype=np.uint8) for _ in range(8)], None, 2048
    if kind == "empty":
        # hostile rows (which take the serial route) between rows of length
        # 0, as a frame's stored blocks are staged: an empty row decodes to
        # 0 bytes and a zero row
        rows, _, cap = _block_batch("hostile", rng)
        empty = np.zeros(0, np.uint8)
        return [r for pair in zip(rows, [empty] * len(rows))
                for r in pair], None, cap
    if kind == "history":
        # tests/test_pallas_decode.py's history cases, against one shared
        # window: records, then a periodic tail the second row continues
        window = np.concatenate([_records(3000), np.tile(
            np.frombuffer(b"ABCDEFGH", np.uint8), 30)])
        rows = [_with_history(_records(2500), window),
                _with_history(np.tile(np.frombuffer(b"ABCDEFGH", np.uint8),
                                      200), window)]
        return rows, window, 4096
    datas = [CASES[k] for k in sorted(k for k in CASES if CASES[k]
                                      is not None)]
    datas += [rng.integers(0, 256, 2000, dtype=np.uint8),
              np.concatenate([rng.integers(0, 256, 3000, dtype=np.uint8),
                              _records(8000), np.full(2000, 3, np.uint8)])]
    return [np.asarray(lz4.compress_raw(d)) for d in datas], None, 16384


@pytest.mark.parametrize("kind", ["valid", "history", "hostile", "empty"])
def test_plain_decode_matches_jax_kernel(kind):
    rows, window, cap = _block_batch(kind, np.random.default_rng(0xD1507))
    M = -(-(max(len(r) for r in rows) + 256) // 1024) * 1024
    comp = np.zeros((len(rows), M), np.uint8)
    lens = np.zeros(len(rows), np.int64)
    for i, r in enumerate(rows):
        comp[i, : len(r)] = r
        lens[i] = len(r)
    hist = None
    jhist = np.zeros((len(rows), W), np.int32)
    if window is not None:
        hist = np.zeros(W, np.uint8)
        hist[W - len(window):] = window
        jhist[:] = hist
    out, out_lens = pt_td.decode_blocks_pallas(
        torch.from_numpy(comp), torch.from_numpy(lens), cap,
        None if hist is None else torch.from_numpy(hist))
    jo, jl = jax_pd.decode_blocks_pallas(
        jnp.asarray(comp.astype(np.int32)),
        jnp.asarray(lens.astype(np.int32)), jnp.asarray(jhist), cap,
        window is not None, True)
    jo, jl = np.asarray(jo), np.asarray(jl)
    np.testing.assert_array_equal(out_lens.numpy(), jl)
    for i, n in enumerate(jl):
        np.testing.assert_array_equal(out[i, :n].numpy(), jo[i, :n] & 0xFF,
                                      err_msg=f"row {i}")
        assert not out[i, n:].any()


def _ext(v: int) -> bytes:
    """An LZ4 length extension of v (>= 15 already in the nibble)."""
    v -= 15
    return b"\xff" * (v // 255) + bytes([v % 255])


def _seq(lit: bytes, off: int = 0, mlen: int = 0) -> bytes:
    """One LZ4 sequence: the literals, then a match of mlen >= 4 bytes at
    offset off (none when mlen is 0: the trailing literal run)."""
    ml = mlen - 4 if mlen else 0
    out = bytes([min(len(lit), 15) << 4 | min(ml, 15)])
    out += (_ext(len(lit)) if len(lit) >= 15 else b"") + lit
    if mlen:
        out += off.to_bytes(2, "little") + (_ext(ml) if ml >= 15 else b"")
    return out


def _never_resync() -> bytes:
    """1056 bytes (32 segments of 33): one sequence of 4 bytes, 349 of 3
    ([00 01 00]: no literals, 4 bytes at offset 1), 5 trailing literal
    bytes. The true tokens lie at 0 and 4 + 3i; a walk started at 33w lies
    on 4 + 3i + 2 and stays there (its token 00 reads offset 0x0100, 3
    bytes a step), so no segment past the first meets the true walk."""
    row = _seq(b"A", 1, 4) + b"\x00\x01\x00" * 349 + _seq(b"WXYZ")
    assert len(row) == 1056
    return row


def _group_edge() -> bytes:
    """One sequence of 8 literals and an 8-byte match at offset 8, 63 of
    no literals and a 4-byte match at offset 4, then 5 literals. Every
    match reads the 4 bytes just before it, so only sequence 32, the
    second group's first, reads bytes that end exactly at its group's
    first output byte: 63 of the 64 matches are copied in order."""
    return _seq(b"ABCDEFGH", 8, 8) + _seq(b"", 4, 4) * 63 + _seq(b"VWXYZ")


def _segmented_case(kind: str, rng):
    """(rows, window or None, block_size) of one case of the segmented
    rendition."""
    if kind in ("valid", "history", "hostile", "empty"):
        return _block_batch(kind, rng)
    if kind == "256k_dict":
        window = _records(40_000)
        return [_with_history(_records(250_000)[9000:], window)], window, \
            256 * KB
    if kind == "never_resync":
        return [np.frombuffer(_never_resync(), np.uint8)], None, 2048
    if kind == "group_edge":
        # and a row whose two matches both read the first literals: both
        # reach into their group
        two = _seq(b"ABCDEFGH", 8, 4) + _seq(b"IJ", 14, 4) + _seq(b"VWXYZ")
        return [np.frombuffer(_group_edge(), np.uint8),
                np.frombuffer(two, np.uint8)], None, 2048
    if kind == "o_limit":
        # the cap binds: in a compressed block, in a match followed by a
        # literal run, in a row's last match (no literals follow), and on
        # the trailing literals of a one-sequence row
        rows = [np.asarray(lz4.compress_raw(_records(3000))),
                np.frombuffer(_seq(b"Q" * 40, 3, 20) + _seq(b"R" * 60),
                              np.uint8),
                np.frombuffer(_seq(b"Q" * 40, 3, 20), np.uint8),
                np.frombuffer(_seq(bytes(range(100))), np.uint8)]
        return rows, None, 50
    # offset > om: a match reaching before the row's start (no history),
    # first or second; and offset 0
    rows = [np.frombuffer(_seq(b"ABCD", 10, 6) + _seq(b"VWXYZ"), np.uint8),
            np.frombuffer(_seq(b"ABCD", 4, 6) + _seq(b"", 11, 4)
                          + _seq(b"VWXYZ"), np.uint8),
            np.frombuffer(_seq(b"ABCD", 0, 6) + _seq(b"VWXYZ"), np.uint8)]
    return rows, None, 2048


def _padded(rows):
    M = -(-(max(len(r) for r in rows) + 256) // 1024) * 1024
    comp = np.zeros((len(rows), M), np.uint8)
    lens = np.array([len(r) for r in rows], np.int64)
    for i, r in enumerate(rows):
        comp[i, : len(r)] = r
    return comp, lens


def _right_aligned(window):
    if window is None:
        return None
    hist = np.zeros(W, np.uint8)
    hist[W - len(window):] = window
    return hist


SEGMENTED = ["valid", "history", "256k_dict", "never_resync", "group_edge",
             "o_limit", "offset_past_om", "hostile", "empty"]


@pytest.mark.parametrize("kind", SEGMENTED)
def test_segmented_rendition_matches_plain_and_jax(kind):
    """decode_blocks_pallas_segmented_plain (the CUDA kernel's split parse,
    stitch, grouped copies and serial route, step by step) equals
    decode_blocks_pallas_plain and the JAX kernel; its stats pin the
    stitch, the group source test and the conformance check."""
    rows, window, cap = _segmented_case(kind, np.random.default_rng(0xD1507))
    comp, lens = _padded(rows)
    hist = _right_aligned(window)
    args = (torch.from_numpy(comp), torch.from_numpy(lens), cap,
            None if hist is None else torch.from_numpy(hist))
    out, out_lens, stats = pt_td.decode_blocks_pallas_segmented_plain(*args)
    want = pt_td.decode_blocks_pallas_plain(*args)
    assert torch.equal(out, want[0]) and torch.equal(out_lens, want[1])
    jhist = np.zeros((len(rows), W), np.int32)
    if hist is not None:
        jhist[:] = hist
    jo, jl = jax_pd.decode_blocks_pallas(
        jnp.asarray(comp.astype(np.int32)),
        jnp.asarray(lens.astype(np.int32)), jnp.asarray(jhist), cap,
        hist is not None, True)
    jo, jl = np.asarray(jo), np.asarray(jl)
    np.testing.assert_array_equal(out_lens.numpy(), jl)
    for i, n in enumerate(jl):
        np.testing.assert_array_equal(out[i, :n].numpy(), jo[i, :n] & 0xFF)
    seqs, redo, in_order, serial = stats.T.tolist()
    expect_serial = {"o_limit": [1] * 4, "offset_past_om": [1] * 3,
                     "hostile": [1] * len(rows),
                     "empty": [1, 0] * (len(rows) // 2)}
    assert serial == expect_serial.get(kind, [0] * len(rows))
    if kind == "empty":
        assert seqs[1::2] == [0] * (len(rows) // 2)
        assert not out_lens[1::2].any() and not out[1::2].any()
    if kind == "never_resync":
        # every segment past the first walked again: 351 sequences, 11 of
        # them (positions 0, 4, ..., 31) in segment 0; of the 350 matches
        # (offset 1) the first of groups 1-10 reads the byte just before
        # its group, the other 340 are copied in order
        assert seqs == [351] and redo == [340] and in_order == [340]
    if kind == "group_edge":
        assert seqs == [65, 3] and in_order == [63, 2]
    if kind in ("valid", "256k_dict"):
        # the stitch meets the speculative walks within a few sequences
        assert all(r <= max(s // 4, 16) for s, r in zip(seqs, redo))
        assert sum(seqs) > 100 and sum(redo) < sum(seqs) // 4


def _linked_rows(kind: str, rng):
    """(rows, stored flags, window, block_size) of one linked chunk."""
    if kind == "frame":
        # a linked 4 KB-block stream: one block's matches reach into the
        # blocks before it and the window; one row stored
        data = np.concatenate([_records(8192),
                               rng.integers(0, 256, 4096, dtype=np.uint8),
                               _records(5000)])
        window = rng.integers(0, 256, W, dtype=np.uint8)
        window[-3000:] = _records(3000)
        rows, stored, hist = [], [], window.copy()
        for at in range(0, len(data), 4096):
            blk = data[at: at + 4096]
            c = _with_history(blk, hist[-W:])
            if len(c) >= len(blk):
                rows.append(blk)
                stored.append(1)
            else:
                rows.append(c)
                stored.append(0)
            hist = np.concatenate([hist, blk])
        return rows, np.array(stored, np.int32), window, 4096
    rows = [rng.integers(0, 256, int(rng.integers(1, 192)), dtype=np.uint8)
            for _ in range(6)]
    stored = np.array([0, 0, 1, 0, 0, 1], np.int32)
    return rows, stored, rng.integers(0, 256, W, dtype=np.uint8), 2048


@pytest.mark.parametrize("kind", ["frame", "hostile"])
def test_linked_chunk_matches_jax_kernel(kind):
    rows, stored, window, bs = _linked_rows(kind, np.random.default_rng(9))
    assert stored.any() and not stored.all()
    M = -(-(max(len(r) for r in rows) + 256) // 1024) * 1024
    comp = np.zeros((len(rows), M), np.uint8)
    lens = np.array([len(r) for r in rows], np.int64)
    for i, r in enumerate(rows):
        comp[i, : len(r)] = r
    out, total, out_lens, win_next = pt_td.decode_linked_chunk(
        torch.from_numpy(comp), torch.from_numpy(lens),
        torch.from_numpy(stored), torch.from_numpy(window), bs)
    jo, jt, jl, jw = jax_pd.decode_linked_chunk_pallas(
        jnp.asarray(comp), jnp.asarray(lens.astype(np.int32)),
        jnp.asarray(stored), jnp.asarray(window), bs, True)
    assert int(total) == int(jt)
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(out[: int(total)].numpy(),
                                  np.asarray(jo)[: int(jt)])
    np.testing.assert_array_equal(win_next.numpy(), np.asarray(jw) & 0xFF)
    assert not out[int(total):].any()


def _mostly_random(n: int, seed: int) -> np.ndarray:
    """Random bytes with a repeated 96-byte run every 1000: a block that
    stays compressed but barely shrinks, so a 1 MB block of it does not
    fit the TPU row budget and takes the scan route."""
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 256, n, dtype=np.uint8)
    rep = rng.integers(0, 256, 96, dtype=np.uint8)
    for at in range(0, n - 96, 1000):
        out[at: at + 96] = rep
    return out


def _frame(name: str):
    """(frame, dictionary, plaintext) of one frame-level case."""
    data = np.concatenate([_records(60_000),
                           np.random.default_rng(2).integers(
                               0, 256, 70_000, dtype=np.uint8)])
    d = np.array(_records(20_000)[5000:])
    cases = {
        "independent_64k": (FrameConfig(block_size=64 * KB,
                                        block_independence=True,
                                        content_checksum=True), None),
        "independent_256k_dict": (FrameConfig(block_size=256 * KB,
                                              block_independence=True), d),
        "independent_1m_scan": (FrameConfig(block_size=MB,
                                            block_independence=True,
                                            content_checksum=True), None),
        "linked_64k_dict": (FrameConfig(block_size=64 * KB,
                                        content_checksum=True), d),
        "linked_4m_scan": (FrameConfig(block_checksums=True), None),
    }
    cfg, dic = cases[name]
    if name == "independent_1m_scan":
        data = _mostly_random(300_000, 3)
    frame = np.asarray(lz4.compress(data, config=cfg, dictionary=dic))
    return frame, dic, data


@pytest.mark.parametrize("name", ["independent_64k", "independent_256k_dict",
                                  "independent_1m_scan", "linked_64k_dict",
                                  "linked_4m_scan"])
def test_frames_match_jax(name):
    frame, dic, data = _frame(name)
    header, blocks, _ = pt_dev.parse_block_index(frame)
    if name.startswith("independent"):
        assert pt_dev._pallas_indep_fits(
            blocks, header["block_max"], dic) == ("scan" not in name)
    got = pt.decompress_frame(frame, dictionary=dic, engine="pallas",
                              device="cpu")
    want = np.asarray(device_decompress_frame(frame, dictionary=dic,
                                              engine="pallas"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data)


def _one_block_frame(frame, block: np.ndarray) -> np.ndarray:
    """*frame*'s header (no checksums) around one new compressed block."""
    _, blocks, _ = pt_dev.parse_block_index(frame)
    head = frame[: blocks[0][0] - 4]
    size = np.array([len(block)], "<u4").view(np.uint8)
    return np.concatenate([head, size, block, np.zeros(4, np.uint8)])


@pytest.mark.parametrize("kind", ["truncated", "zero_offset"])
def test_scan_route_errors_match_jax(kind):
    data = _records(20_000)
    frame = np.asarray(lz4.compress(data, config=FrameConfig()))
    _, blocks, _ = pt_dev.parse_block_index(frame)
    off, size, _ = blocks[0]
    block = frame[off: off + size].copy()
    if kind == "truncated":
        block = block[: size - 7]
    else:
        # zero the first sequence's offset: past its token, literal
        # length extension and literals
        lit, p = int(block[0] >> 4), 1
        if lit == 15:
            while True:
                v = int(block[p])
                p += 1
                lit += v
                if v != 255:
                    break
        block[p + lit: p + lit + 2] = 0
    bad = _one_block_frame(frame, block)
    with pytest.raises(ValueError) as ref:
        device_decompress_frame(bad, engine="pallas")
    with pytest.raises(ValueError) as got:
        pt.decompress_frame(bad, engine="pallas", device="cpu")
    assert str(got.value) == str(ref.value)
    assert str(got.value).startswith("LZ4: ")


def _outcome(fn):
    try:
        return "bytes", np.asarray(fn()).tobytes()
    except (ValueError, IndexError) as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("linked", [False, True], ids=["independent",
                                                       "linked"])
def test_mutated_frames_match_jax(linked):
    """Frames with one byte changed (tests/test_fuzz.py:172,192): the port
    gives the JAX package's bytes or its error, so every clamp of the
    interpreter is the TPU kernel's."""
    rng = np.random.default_rng(11 + linked)
    # linked: the second block's records match the first block's
    data = np.concatenate([_records(3000),
                           rng.integers(0, 256, 62_000 if linked else 500,
                                        dtype=np.uint8),
                           _records(3000 if linked else 0)])
    base = np.asarray(lz4.compress(data, config=FrameConfig(
        block_size=64 * KB, block_independence=not linked)))
    for trial in range(12):
        buf = base.copy()
        buf[int(rng.integers(6, len(buf)))] = int(rng.integers(0, 256))
        want = _outcome(lambda: device_decompress_frame(buf,
                                                        engine="pallas"))
        got = _outcome(lambda: pt.decompress_frame(buf, engine="pallas",
                                                   device="cpu"))
        assert got == want, f"trial {trial}"


@pytest.mark.cuda
def test_cuda_blocks_kernel_matches_plain(cuda):
    """The kernel against the plain version and its stats against the
    segmented rendition's on every case of the rendition's test."""
    for kind in SEGMENTED:
        rows, window, cap = _segmented_case(kind,
                                            np.random.default_rng(0xD1507))
        comp, lens = _padded(rows)
        hist = _right_aligned(window)
        args = (torch.from_numpy(comp), torch.from_numpy(lens), cap,
                None if hist is None else torch.from_numpy(hist))
        want = pt_td.decode_blocks_pallas_plain(*args)
        got = pt_td.decode_blocks_pallas(
            args[0].to(cuda), args[1].to(cuda), cap,
            None if hist is None else args[3].to(cuda))
        for g, w in zip(got, want):
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
        stats = pt_td.decode_blocks_pallas_segmented_plain(*args)[2]
        assert torch.equal(pt_td.decode_blocks_pallas.last_stats.cpu().long(),
                           stats), kind


@pytest.mark.cuda
def test_cuda_blocks_kernel_zeroes_empty_rows(cuda):
    """Rows of length 0 (a frame's stored blocks) between hostile rows,
    more rows than the card runs at once, over device memory filled with
    0xFF before each call: every empty row decodes to 0 bytes and a zero
    row, whatever the SM's shared memory held before its block (the
    serial route of a hostile row leaves its flag set there)."""
    rng = np.random.default_rng(0xE3)
    rows = []
    for _ in range(512):
        rows += [rng.integers(0, 256, int(rng.integers(1, 192)),
                              dtype=np.uint8), np.zeros(0, np.uint8)]
    comp, lens = _padded(rows)
    cap = 4096
    want = pt_td.decode_blocks_pallas_plain(torch.from_numpy(comp),
                                            torch.from_numpy(lens), cap)
    comp_d, lens_d = torch.from_numpy(comp).to(cuda), \
        torch.from_numpy(lens).to(cuda)
    for trial in range(8):
        poison = torch.full((len(rows), cap), 255, dtype=torch.uint8,
                            device=cuda)
        del poison   # the kernel's output takes this block back
        got = pt_td.decode_blocks_pallas(comp_d, lens_d, cap)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0,
                                       msg=f"trial {trial}")


@pytest.mark.cuda
def test_cuda_chains_kernel_matches_plain(cuda):
    rng = np.random.default_rng(6)
    for kind in ("frame", "hostile"):
        rows, stored, window, bs = _linked_rows(kind, rng)
        comp = np.concatenate(rows)
        comp_off = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
        n = len(rows)
        # one chain of every row, then each row as its own chain
        for row_off in (np.array([0, n]), np.arange(n + 1)):
            out_off = row_off * bs
            batch = pt_td.TokenChains(
                torch.from_numpy(comp), torch.from_numpy(comp_off),
                torch.from_numpy(stored.astype(np.uint8)),
                torch.from_numpy(row_off), torch.from_numpy(out_off),
                torch.from_numpy(window), bs, int(out_off[-1]))
            want = pt_td.decode_token_chains_plain(batch)
            got = pt_td.decode_token_chains(
                pt_td.TokenChains(*(x.to(cuda) if torch.is_tensor(x) else x
                                    for x in batch)))
            for g, w in zip(got, want):
                torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_chains_kernel_matches_plain_on_linked_4m_blocks(cuda):
    """The default frame's row shape and chaining: one chain of three
    linked 4 MB blocks, staged as decompress_frame stages it (scan route).
    60000-byte periods of records with one byte changed in each keep the
    sequences, and so the plain version's steps, few."""
    rng = np.random.default_rng(7)
    n = 3 * 4 * MB - 5000
    data = np.tile(_records(60_000), n // 60_000 + 1)[:n]
    data[np.arange(0, n - 60_000, 60_000) + rng.integers(0, 60_000)] = \
        ord("#")
    frame = np.asarray(lz4.compress(data, config=FrameConfig()))
    header, blocks, _ = pt_dev.parse_block_index(frame)
    assert len(blocks) == 3 and not header["independent"]
    batch, _, _ = pt_dev.stage_token_chains(frame, blocks, header, None,
                                            "cpu", True)
    want = pt_td.decode_token_chains_plain(batch)
    got = pt_td.decode_token_chains(
        pt_td.TokenChains(*(x.to(cuda) if torch.is_tensor(x) else x
                            for x in batch)))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    assert want[0][: n].numpy().tobytes() == data.tobytes()


@pytest.mark.parametrize("name", ["linked_64k_dict", "linked_4m_scan"])
def test_resolved_linked_frames_match_jax(name):
    """The parallel design's plain rendition (rows parsed alone, cursor
    scan, pointer doubling) on a frame's staged chains gives the JAX
    engine="pallas" decode."""
    frame, dic, data = _frame(name)
    header, blocks, _ = pt_dev.parse_block_index(frame)
    window = None if dic is None else np.asarray(dic)[-W:]
    batch, starts, out_off = pt_dev.stage_token_chains(
        frame, blocks, header, window, "cpu", "4m" in name)
    out, out_lens, _ = pt_td.decode_token_chains_resolved(batch)
    want = np.asarray(device_decompress_frame(frame, dictionary=dic,
                                              engine="pallas"))
    np.testing.assert_array_equal(out[: int(out_lens.sum())].numpy(), want)
    np.testing.assert_array_equal(want, data)


def test_scanned_blocks_stage_as_piece_rows():
    """With the scan, each compressed block is staged as its scanned
    pieces (rows cut at sequence boundaries, >= 64 KB of output each) and
    a stored block as one row; the chain decodes to the frame's bytes, as
    with one row per block."""
    data = np.concatenate([_records(256 * KB),
                           np.random.default_rng(4).integers(
                               0, 256, 256 * KB, dtype=np.uint8),
                           _records(200_000)])
    frame = np.asarray(lz4.compress(data, config=FrameConfig(
        block_size=256 * KB)))
    header, blocks, _ = pt_dev.parse_block_index(frame)
    assert any(st for *_, st in blocks)
    outs = {}
    for scan in (True, False):
        batch, starts, out_off = pt_dev.stage_token_chains(
            frame, blocks, header, None, "cpu", scan)
        out, out_lens = pt_td.decode_token_chains_plain(batch)
        outs[scan] = out[: int(out_lens.sum())].numpy()
        assert len(starts) == 2 and int(out_off[-1]) == batch.out_total
        n_rows = batch.stored.shape[0]
        assert (n_rows > len(blocks)) == scan
    assert int(batch.stored.sum()) == sum(st for *_, st in blocks)
    np.testing.assert_array_equal(outs[True], data)
    np.testing.assert_array_equal(outs[False], data)
