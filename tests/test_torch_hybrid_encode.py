"""The torch port's engine="hybrid" encode held against the JAX package on
the CPU.

The port's build_chains must equal the JAX build_chains element for
element; its plain walk (hybrid_walk_plain, the CUDA kernel's twin) must
equal the JAX encode_blocks_hybrid (its Pallas kernel in interpret mode)
over [0, out_len), out_len and the meta lanes included, and the JAX
exact-chain split encode (encode_blocks_chain(exact=True) +
chain_select_serialize), which JAX states is byte-identical;
compress_frame(engine="hybrid") must equal the JAX
device_compress_frame(engine="hybrid") and decode exactly with both of the
port's decode engines. Tolerance: exact bytes everywhere; the port's rows
are zero past out_len, where the TPU kernel leaves wild writes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divortio_lz4_tpu_torch as pt
from _torch_port import cuda, mixed_payload  # noqa: F401  (cuda: fixture)
from _torch_port import one_torch_thread  # noqa: F401  (fixture)
from conftest import make_compressible
from divortio_lz4_tpu.config import FrameConfig
from divortio_lz4_tpu.ops import hybrid_encode as jax_he
from divortio_lz4_tpu.ops.split_encode import encode_block_split_host
from divortio_lz4_tpu.parallel.device import (device_compress_frame,
                                              device_decompress_frame)
from divortio_lz4_tpu_torch.ops import hybrid_encode as pt_he
from divortio_lz4_tpu_torch.ops import split_encode as pt_se
from test_hybrid_encode import _adversarial_cases
from test_split_encode import CASES

KB = 1024
W = 65536


def _batch(rows, B, hist=None):
    """u8[nb, hist_len + B] rows ([history | payload]) and i64 lengths."""
    hl = 0 if hist is None else W
    work = np.zeros((len(rows), hl + B), np.uint8)
    lens = np.zeros(len(rows), np.int64)
    for i, r in enumerate(rows):
        if hist is not None:
            work[i, :W] = hist[i]
        work[i, hl: hl + len(r)] = r
        lens[i] = len(r)
    return work, lens


def _mixed_rows(seed):
    """tests/test_hybrid_encode.py:54's 5-row batch (B = 2048)."""
    rng = np.random.default_rng(seed)
    B = 2048
    return [make_compressible(B), rng.integers(0, 256, B, dtype=np.uint8),
            make_compressible(700), np.tile(np.array([5, 6], np.uint8),
                                            B // 2),
            np.zeros(B, np.uint8)]


def _history_case(kind, seed):
    """(rows, history rows, hist_start) for a dictionary or linked batch of
    4 KB blocks: a dictionary right-aligned in every row, or each row's
    preceding plaintext with per-row hist_start."""
    data = mixed_payload(5 * 4 * KB, seed)
    rows = [data[i * 4 * KB: (i + 1) * 4 * KB] for i in range(5)]
    hist = np.zeros((5, W), np.uint8)
    if kind == "dictionary":
        d = make_compressible(3000)
        hist[:, W - len(d):] = d
        return rows, hist, W - len(d)
    starts = np.zeros(5, np.int64)
    for i in range(5):
        hist[i, W - i * 4 * KB:] = data[: i * 4 * KB]
        starts[i] = W - i * 4 * KB
    return rows, hist, starts


@pytest.mark.parametrize("kind", ["no_history", "dictionary", "linked"])
def test_build_chains_match_jax(kind):
    if kind == "no_history":
        rows, hist, hs = _mixed_rows(1) + [make_compressible(16 * KB)], \
            None, 0
        B = 16 * KB
    else:
        (rows, hist, hs), B = _history_case(kind, 2), 4 * KB
    work, lens = _batch(rows, B, hist)
    hl = 0 if hist is None else W
    got = pt_he.build_chains(torch.from_numpy(work), torch.from_numpy(lens),
                             hl, torch.as_tensor(hs))
    want = np.asarray(jax_he.build_chains(
        jnp.asarray(work.astype(np.int32)), jnp.asarray(lens.astype(np.int32)),
        hl, jnp.asarray(np.asarray(hs, np.int32))))
    assert got.dtype == torch.int32 and got.shape == (len(rows), B)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got == -1).any()        # the sentinel: no match remains


def _jax_walk(work, lens, B, hl, hs):
    """JAX encode_blocks_hybrid in interpret mode: (rows, out_lens, meta
    lanes 1-4 of each row's last 128-lane row)."""
    out, out_len = jax_he.encode_blocks_hybrid(
        jnp.asarray(work.astype(np.int32)), jnp.asarray(lens.astype(np.int32)),
        B, hl, jnp.asarray(np.asarray(hs, np.int32)), True)
    out = np.asarray(out)
    return out, np.asarray(out_len), out[:, -128:][:, 1:5]


@pytest.mark.parametrize("case", ["mixed_rows", "dictionary_row"])
def test_plain_walk_matches_jax_kernel(case):
    if case == "mixed_rows":
        rows, hist, hs, B = _mixed_rows(3), None, 0, 2048
    else:
        d = make_compressible(8000)
        hist = np.zeros((1, W), np.uint8)
        hist[0, W - len(d):] = d
        rows, hs, B = [make_compressible(6000)], W - len(d), 6 * KB
    work, lens = _batch(rows, B, hist)
    hl = 0 if hist is None else W
    out, out_lens, meta = pt_he.encode_blocks_hybrid(
        torch.from_numpy(work), torch.from_numpy(lens), B, hl, hs)
    jo, jl, jmeta = _jax_walk(work, lens, B, hl, hs)
    assert out.shape == (len(rows), B + B // 255 + 16)
    np.testing.assert_array_equal(out_lens.numpy(), jl)
    np.testing.assert_array_equal(meta.numpy(), jmeta)
    for i, n in enumerate(jl):
        np.testing.assert_array_equal(out[i, :n].numpy(), jo[i, :n],
                                      err_msg=f"row {i}")
        assert not out[i, n:].any()


def _segment_case(case):
    """(rows, B, history rows or None, hist_start) for the segmented walk:
    segment boundaries inside a long match and inside literal runs, the
    periodic adversarial rows, small-alphabet rows whose segments meet late
    (the stitch walks on), rows shorter than a segment, an empty row and a
    dictionary row."""
    rng = np.random.default_rng(len(case))
    B = 16 * KB
    r = rng.integers(0, 256, B, dtype=np.uint8)
    if case == "boundary_in_long_match":
        r[3000:9000] = r[100:6100]
        return [r], B, None, 0
    if case == "boundary_in_literal_run":
        r[12000:12100] = r[500:600]
        return [r, make_compressible(B)], B, None, 0
    if case.startswith("adversarial_"):
        rows = [_adversarial_cases(rng)[k][:B] for k in case[12:].split("+")]
        return rows, B, None, 0
    if case == "small_alphabet":
        return [rng.integers(0, a, B, dtype=np.uint8) for a in (2, 3, 4)], \
            B, None, 0
    if case == "shorter_than_segment":
        return [r[:10], r[:20], make_compressible(100)[:100],
                make_compressible(700)], 2048, None, 0
    if case == "empty":
        return [np.zeros(0, np.uint8), r], B, None, 0
    d = make_compressible(8000)               # the dictionary row
    hist = np.zeros((1, W), np.uint8)
    hist[0, W - len(d):] = d
    return [make_compressible(6000)], 6 * KB, hist, W - len(d)


SEGMENT_CASES = ["boundary_in_long_match", "boundary_in_literal_run",
                 "adversarial_period53+period4+runs",
                 "adversarial_period8+period64+period53_mut",
                 "small_alphabet", "shorter_than_segment", "empty",
                 "dictionary_row"]


@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_segmented_rendition_matches_plain_and_jax(case):
    """hybrid_walk_segmented_plain (the kernel's speculative segments,
    stitch and offsets) equals hybrid_walk_plain at 8, 16 and 32 segments,
    out_len and meta lanes included, and the JAX kernel in interpret
    mode."""
    rows, B, hist, hs = _segment_case(case)
    work, lens = _batch(rows, B, hist)
    hl = 0 if hist is None else W
    w, ln = torch.from_numpy(work), torch.from_numpy(lens)
    chains = pt_he.build_chains(w, ln, hl, torch.as_tensor(hs))
    want = pt_he.hybrid_walk_plain(w, ln, chains, hl)
    rewalked = 0
    for segs in (8, 16, 32):
        *got, redo = pt_he.hybrid_walk_segmented_plain(w, ln, chains, hl,
                                                       segs)
        for g, x in zip(got, want):
            assert torch.equal(g, x), segs
        rewalked += int(redo.sum())
    if case == "small_alphabet":            # the stitch walked on
        assert rewalked > 0
    jo, jl, jmeta = _jax_walk(work, lens, B, hl, hs)
    np.testing.assert_array_equal(want[1].numpy(), jl)
    np.testing.assert_array_equal(want[2].numpy(), jmeta)
    for i, n in enumerate(jl):
        np.testing.assert_array_equal(want[0][i, :n].numpy(), jo[i, :n])


SPLIT_EXACT = sorted(CASES) + [f"adversarial_{k}" for k in (
    "period53", "period4", "period8", "period64", "runs", "aligned_pages",
    "runs_spacers", "period53_mut")]


@pytest.mark.parametrize("name", SPLIT_EXACT)
def test_plain_walk_matches_split_exact(name, rng):
    """JAX: exact chains + the host serializer give the hybrid walk's
    bytes (test_split_encode.py). The port's walk gives them too, and so
    does the port's own split encode with exact=True."""
    data = _adversarial_cases(rng)[name[12:]] if name.startswith(
        "adversarial_") else CASES[name]
    B = 32 * KB
    want = np.asarray(encode_block_split_host(data, B, exact=True))
    got = pt_he.encode_block_hybrid_host(data, block_size=B, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        pt_se.encode_block_split_host(data, B, exact=True, device="cpu"),
        want)


def test_walk_refuses_blocks_over_64k():
    work = torch.zeros((1, 2 * W), dtype=torch.uint8)
    lens = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="16 bits"):
        pt_he.encode_blocks_hybrid(work, lens, 2 * W)
    with pytest.raises(ValueError, match="16 bits"):
        pt_he.build_chains(work, lens, 0, 0)


FRAMES = {
    "independent_4k": (FrameConfig(block_size=4 * KB,
                                   block_independence=True), False),
    "linked_4k": (FrameConfig(block_size=4 * KB, block_independence=False,
                              content_checksum=True), False),
    "dictionary": (FrameConfig(block_size=4 * KB, block_independence=True,
                               content_checksum=True), True),
    "linked_dictionary": (FrameConfig(block_size=4 * KB,
                                      block_independence=False), True),
    "block_checksums": (FrameConfig(block_size=4 * KB,
                                    block_independence=True,
                                    block_checksums=True), False),
    "256k_big_route": (FrameConfig(block_size=256 * KB,
                                   block_independence=True), False),
}


@pytest.mark.parametrize("name", list(FRAMES))
def test_frames_match_jax(name):
    cfg, use_dict = FRAMES[name]
    data = mixed_payload(100_000 if name.startswith("256k") else 24_000, 5)
    d = np.array(make_compressible(5000)) if use_dict else None
    want = np.asarray(device_compress_frame(data, cfg, dictionary=d,
                                            engine="hybrid"))
    got = pt.compress_frame(data, cfg, dictionary=d, engine="hybrid",
                            device="cpu")
    assert got.tobytes() == want.tobytes()
    for engine in ("split", "pallas"):
        out = pt.decompress_frame(got, dictionary=d, engine=engine,
                                  device="cpu")
        assert out.tobytes() == data.tobytes(), engine


def test_empty_payload_frame_has_no_block():
    cfg = FrameConfig(block_size=64 * KB, block_independence=True)
    got = pt.compress_frame(b"", cfg, engine="hybrid", device="cpu")
    want = np.asarray(device_compress_frame(b"", cfg, engine="hybrid"))
    assert got.tobytes() == want.tobytes()
    for engine in ("split", "pallas"):
        assert pt.decompress_frame(got, engine=engine,
                                   device="cpu").tobytes() == b""


@pytest.mark.usefixtures("one_torch_thread")
def test_unported_routes_raise():
    """The two routes that used to raise are ported: linked frames with
    block checksums (the host frame encoder) and hybrid decode (the XLA
    decoder), each equal to JAX's bytes."""
    data = mixed_payload(10_000, 6)
    cfg = FrameConfig(block_size=4 * KB, block_independence=False,
                      block_checksums=True)
    got = pt.compress_frame(data, cfg, engine="hybrid", device="cpu")
    assert got.tobytes() == np.asarray(device_compress_frame(
        data, cfg, engine="hybrid")).tobytes()
    frame = pt.compress_frame(data, cfg.with_(block_independence=True),
                              engine="hybrid", device="cpu")
    out = pt.decompress_frame(frame, engine="hybrid", device="cpu")
    assert out.tobytes() == np.asarray(device_decompress_frame(
        frame, engine="hybrid")).tobytes() == data.tobytes()


def test_frames_in_flight_keep_order():
    """compress_frames queues every hybrid frame before its one fetch;
    each frame equals its own compress_frame."""
    cfg = FrameConfig(block_size=4 * KB, block_independence=True,
                      content_checksum=True)
    datas = [mixed_payload(9000, 7), b"", mixed_payload(5000, 8)]
    frames = pt.compress_frames(datas, cfg, engine="hybrid", device="cpu")
    for f, x in zip(frames, datas):
        assert f.tobytes() == pt.compress_frame(
            x, cfg, engine="hybrid", device="cpu").tobytes()
        assert pt.decompress_frame(f, device="cpu").tobytes() == bytes(x)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda):
    """encode_blocks_hybrid (chains, then the walk kernel) against its
    plain version: the mixed rows, 64 KB rows (random, zero, short, empty)
    and dictionary and linked rows; launches goes up by one per call."""
    rng = np.random.default_rng(8)
    rows64 = [mixed_payload(W, s) for s in range(3)] + [
        rng.integers(0, 256, W, dtype=np.uint8), np.zeros(W, np.uint8),
        np.arange(10, dtype=np.uint8), np.zeros(0, np.uint8)]
    cases = [(_mixed_rows(3), 2048, None, 0), (rows64, W, None, 0)]
    cases += [_segment_case(c) for c in SEGMENT_CASES]
    for kind in ("dictionary", "linked"):
        rows, hist, hs = _history_case(kind, 9)
        cases.append((rows, 4 * KB, hist, hs))
    for rows, B, hist, hs in cases:
        work, lens = _batch(rows, B, hist)
        hl = 0 if hist is None else W
        w = torch.from_numpy(work).to(cuda)
        ln = torch.from_numpy(lens).to(cuda)
        hs = torch.as_tensor(hs).to(cuda)
        want = pt_he.encode_blocks_hybrid_plain(w, ln, B, hl, hs)
        before = pt_he.hybrid_walk.launches
        got = pt_he.encode_blocks_hybrid(w, ln, B, hl, hs)
        assert pt_he.hybrid_walk.launches == before + 1
        for g, x in zip(got, want):
            torch.testing.assert_close(g.cpu(), x.cpu(), rtol=0, atol=0)
        # the stitch re-walks what the rendition re-walks
        chains = pt_he.build_chains(w, ln, hl, hs)
        redo = pt_he.hybrid_walk_segmented_plain(
            w.cpu(), ln.cpu(), chains.cpu(), hl, pt_he.WALK_WARPS)[3]
        torch.testing.assert_close(pt_he.hybrid_walk.last_rewalked.cpu(),
                                   redo, rtol=0, atol=0)
