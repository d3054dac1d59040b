"""The torch port's encode half held against the JAX package on the CPU.

Chains from divortio_lz4_tpu_torch.ops.hybrid_encode.build_dist_chains must
equal the JAX build_dist_chains element for element (tolerance: exact), in
both key layouts, with and without a dictionary history row, over ragged
lengths; the serializer copy must emit the same wire bytes.
"""

import numpy as np
import pytest
import torch

from _torch_port import REC, cuda  # noqa: F401  (cuda: fixture)
from divortio_lz4_tpu.ops import encode_xla as jax_encode_xla
from divortio_lz4_tpu.ops import hybrid_encode as jax_hybrid
from divortio_lz4_tpu.ops import split_encode as jax_split
from divortio_lz4_tpu_torch.ops import hybrid_encode as pt_hybrid
from divortio_lz4_tpu_torch.ops import split_encode as pt_split

BS = 8192


def _rows(seed=1):
    """Three ragged rows: JSON-like records, a 4-letter alphabet (dense,
    long runs of candidates), random bytes (no matches); zero-padded past
    their lengths as the frame path pads them."""
    rng = np.random.default_rng(seed)
    rows = [np.frombuffer((REC % 7 * (BS // len(REC % 7) + 1))[:BS],
                          np.uint8),
            rng.integers(0, 4, BS).astype(np.uint8),
            rng.integers(0, 256, BS).astype(np.uint8)]
    work = np.stack(rows).astype(np.int32)
    lens = np.array([BS, 5000, BS - 13], np.int32)
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


def test_build_dist_chains_per_row_hist_start():
    """hist_start given per row (the linked-frame form) matches too."""
    work, lens = _rows(seed=4)
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


@pytest.mark.cuda
def test_build_dist_chains_cuda_matches_cpu(cuda):
    for hist in (False, True):
        work, lens = _rows(seed=6)
        hist_len, hs = 0, 0
        if hist:
            hist_len = 65536
            work, hs = _with_history(work, hist_len, 3000)
        for hashed in (True, False):
            want = pt_hybrid.build_dist_chains(
                torch.from_numpy(work), torch.from_numpy(lens), hist_len,
                hs, hashed=hashed)
            got = pt_hybrid.build_dist_chains(
                torch.from_numpy(work).to(cuda),
                torch.from_numpy(lens).to(cuda), hist_len, hs,
                hashed=hashed)
            assert torch.equal(got.cpu(), want)
