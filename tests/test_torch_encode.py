"""The torch port's encode half held against the JAX package on the CPU.

Chains from divortio_lz4_tpu_torch.ops.hybrid_encode.build_dist_chains must
equal the JAX build_dist_chains element for element (tolerance: exact), in
both key layouts, with and without a dictionary history row, over ragged
lengths; the serializer copy must emit the same wire bytes.
"""

import numpy as np
import pytest
import torch

from _torch_port import (REC, cuda,  # noqa: F401  (cuda: fixture)
                         mixed_payload)
from divortio_lz4_tpu.ops import encode_xla as jax_encode_xla
from divortio_lz4_tpu.ops import hybrid_encode as jax_hybrid
from divortio_lz4_tpu.ops import split_encode as jax_split
from divortio_lz4_tpu_torch.ops import hybrid_encode as pt_hybrid
from divortio_lz4_tpu_torch.ops import split_encode as pt_split

BS = 8192


def _rows(seed=1, bs=BS):
    """Three ragged rows: JSON-like records, a 4-letter alphabet (dense,
    long runs of candidates), random bytes (no matches); zero-padded past
    their lengths as the frame path pads them."""
    rng = np.random.default_rng(seed)
    rows = [np.frombuffer((REC % 7 * (bs // len(REC % 7) + 1))[:bs],
                          np.uint8),
            rng.integers(0, 4, bs).astype(np.uint8),
            rng.integers(0, 256, bs).astype(np.uint8)]
    work = np.stack(rows).astype(np.int32)
    lens = np.array([bs, 5000, bs - 13], np.int32)
    for i, n in enumerate(lens):
        work[i, n:] = 0
    return work, lens


def _with_history(work, hist_len, dict_len):
    hist = np.zeros((work.shape[0], hist_len), np.int32)
    hist[:, hist_len - dict_len:] = np.frombuffer(
        (REC % 3 * (dict_len // 10))[:dict_len], np.uint8)
    return np.concatenate([hist, work], axis=1), hist_len - dict_len


@pytest.mark.parametrize("hashed", [True, False], ids=["hashed", "exact"])
@pytest.mark.parametrize("history", [False, True], ids=["nohist", "hist"])
def test_build_dist_chains_matches_jax(hashed, history):
    work, lens = _rows()
    hist_len, hist_start = 0, 0
    if history:
        # N = 64 KB + 8 KB > 2**16: the history-row (un-sort by scatter)
        # branch, the one dictionary frames reach.
        hist_len = 65536
        work, hist_start = _with_history(work, hist_len, 3000)
    want = np.asarray(jax_hybrid.build_dist_chains(
        work, lens, hist_len, hist_start, hashed=hashed))
    got = pt_hybrid.build_dist_chains(
        torch.from_numpy(work), torch.from_numpy(lens), hist_len,
        hist_start, hashed=hashed).numpy()
    assert got.dtype == np.uint16 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (got != 0).sum() > 1000  # the rows do carry matches


@pytest.mark.parametrize("bs", [BS, 65536], ids=["8k", "64k"])
def test_build_dist_chains_per_row_hist_start(bs):
    """hist_start given per row (the linked-frame form) matches too; at
    64 KB rows N = 2**17, the linked cells' width, with a short row."""
    work, lens = _rows(seed=4, bs=bs)
    work, _ = _with_history(work, 65536, 6000)
    hs = np.array([65536 - 6000, 65536 - 100, 65536], np.int32)
    want = np.asarray(jax_hybrid.build_dist_chains(work, lens, 65536, hs))
    got = pt_hybrid.build_dist_chains(torch.from_numpy(work),
                                      torch.from_numpy(lens), 65536,
                                      torch.from_numpy(hs)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 1000, 65537])
def test_pows_matches_jax(n):
    for base in (jax_encode_xla._B1, jax_encode_xla._B1_INV):
        want = np.asarray(jax_encode_xla._pows(base, n)).astype(np.int64)
        got = pt_hybrid._pows(base, n, "cpu").numpy()
        np.testing.assert_array_equal(got, want)


def test_mul32_is_u32_multiply():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 2**32, 4096, dtype=np.uint64)
    b = rng.integers(0, 2**32, 4096, dtype=np.uint64)
    want = (a * b) & np.uint64(0xFFFFFFFF)   # uint64 wraps mod 2**64
    got = pt_hybrid._mul32(torch.from_numpy(a.astype(np.int64)),
                           torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    got_c = pt_hybrid._mul32(torch.from_numpy(a.astype(np.int64)),
                             0xC2B2AE3D)
    np.testing.assert_array_equal(
        got_c.numpy(), ((a * np.uint64(0xC2B2AE3D))
                        & np.uint64(0xFFFFFFFF)).astype(np.int64))


def test_encode_blocks_chain_chunks_match_jax(monkeypatch):
    """Row chunking (CHAIN_CHUNK_ROWS) changes nothing: 3 rows in chunks
    of 2 equal the JAX encode_blocks_chain."""
    work, lens = _rows(seed=2)
    work8 = work.astype(np.uint8)
    want = np.asarray(jax_split.encode_blocks_chain(work8, lens, BS))
    monkeypatch.setattr(pt_split, "CHAIN_CHUNK_ROWS", 2)
    got = pt_split.encode_blocks_chain(work8, lens, BS, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_chain_select_serialize_matches_jax():
    work, lens = _rows(seed=3)
    chains = np.asarray(jax_hybrid.build_dist_chains(work, lens, 0, 0))
    for r in range(work.shape[0]):
        n = int(lens[r])
        padded = np.zeros(BS + 8, np.uint8)
        padded[:n] = work[r, :n]
        want = jax_split.chain_select_serialize(padded, 0, n, chains[r])
        got = pt_split.chain_select_serialize(padded, 0, n, chains[r])
        np.testing.assert_array_equal(got, want)


def test_encode_blocks_chain_rejects_bad_width():
    work, lens = _rows()
    with pytest.raises(ValueError, match="block_size"):
        pt_split.encode_blocks_chain(work.astype(np.uint8), lens, BS + 1,
                                     device="cpu")


# The card cases: the 8 KB int32 rows of _rows, alone (N = 8192, ibits 13)
# or after 64 KB of history (N = 73728, ibits 17), hashed and exact; two
# widths that are no multiple of 256 and end in a partial 4096-position
# tile (1000 or 65499 bytes of history before 8 KB: N = 9192, 73691); and
# u8 rows at the shapes the benchmark cells run: 64 KB rows, alone
# (N = 2**16) or after 64 KB of history (N = 2**17).
SMALL_CARD_CASES = [f"8k-{h}-{k}" for h in ("nohist", "hist")
                    for k in ("hashed", "exact")] + ["odd-9192", "odd-73691"]
BIG_CARD_CASES = ["indep64k", "linked64k", "short_last", "zeros", "random",
                  "dictionary", "exact64k"]


def _card_case(name):
    """(work, lens, hist_len, hist_start, hashed) of a card case."""
    if name.startswith("8k-"):
        _, hist, kind = name.split("-")
        work, lens = _rows(seed=6)
        hist_len, hs = 0, 0
        if hist == "hist":
            hist_len = 65536
            work, hs = _with_history(work, hist_len, 3000)
        return work, lens, hist_len, hs, kind == "hashed"
    if name.startswith("odd-"):
        work, lens = _rows(seed=7)
        hist_len = int(name[4:]) - BS
        work, hs = _with_history(work, hist_len, min(hist_len, 3000))
        return work, lens, hist_len, hs, True
    B = 65536
    rng = np.random.default_rng(11)
    text = mixed_payload(8 * B, 11)
    if name in ("indep64k", "short_last", "zeros", "random"):
        work = text[: 4 * B].reshape(4, B).copy()
        lens = np.full(4, B, np.int64)
        if name == "short_last":
            lens[3] = 1000
            work[3, 1000:] = 0
        elif name == "zeros":
            work[1] = 0                  # runs: every position interior
        elif name == "random":
            work[2] = rng.integers(0, 256, B)
        return work, lens, 0, 0, True
    # linked 64 KB rows: each row's history is the 64 KB before it
    hs = np.zeros(4, np.int64)
    if name == "dictionary":
        work = np.zeros((4, 2 * B), np.uint8)
        work[:, B - 32768: B] = text[:32768]          # 32 KB dictionary
        work[:, B:] = text[B: 5 * B].reshape(4, B)
        hs[:] = B - 32768
    else:
        work = np.stack([text[i * B: (i + 2) * B] for i in range(4)])
        hs[0] = B                                     # the frame's start
    lens = np.array([B, B, B, B - 7], np.int64)
    work[3, B + lens[3]:] = 0
    return work, lens, B, hs, name != "exact64k"


@pytest.mark.cuda
@pytest.mark.parametrize("name", SMALL_CARD_CASES + BIG_CARD_CASES)
def test_build_dist_chains_cuda_matches_cpu(cuda, name, monkeypatch):
    """The CUDA builder (hashed) or the torch ops on the card (exact) equal
    the JAX builder element for element (and so do the port's torch ops
    on the CPU), through build_dist_chains and through
    encode_blocks_chain's chunks, one kernel launch a chunk."""
    work, lens, hist_len, hs, hashed = _card_case(name)
    want = np.asarray(jax_hybrid.build_dist_chains(
        work.astype(np.int32), lens.astype(np.int32), hist_len,
        np.asarray(hs, np.int32), hashed=hashed))
    assert (want != 0).sum() > 1000  # the rows do carry matches
    plain = pt_hybrid.build_dist_chains(
        torch.from_numpy(work), torch.from_numpy(lens), hist_len,
        torch.from_numpy(np.asarray(hs)), hashed=hashed)
    np.testing.assert_array_equal(plain.numpy(), want)
    got = pt_hybrid.build_dist_chains(
        torch.from_numpy(work).to(cuda), torch.from_numpy(lens).to(cuda),
        hist_len, hs, hashed=hashed)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    monkeypatch.setattr(pt_split, "CHAIN_CHUNK_ROWS", 2)
    before = pt_hybrid.build_dist_chains.launches
    got = pt_split.encode_blocks_chain(
        work, lens, work.shape[1] - hist_len, hist_len, hs, device=cuda,
        exact=not hashed)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    chunks = -(-work.shape[0] // 2)
    assert pt_hybrid.build_dist_chains.launches - before == (
        chunks if hashed else 0)
