"""The torch port's encode_linked_scan held against the JAX package on the
CPU.

The port builds every ``[window_i | row_i]`` row with one gather and
encodes them in one batch; JAX carries the window through a ``lax.scan``.
On the same numpy inputs the two must give equal out_lens and equal bytes
over ``[0, out_len)`` for every row (tolerance: exact), and the port's rows
are zero past out_len. The cases: 64 KB corpus rows, a 40 KB dictionary
whose window holds non-zero bytes left of ``W - filled``, uneven rows with
an empty row in the middle, 256 KB rows (wider than the window), the
encoder without fingerprints and no rows at all. The scan's rows also
equal the blocks of the port's linked engine="xla" frame.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divortio_lz4_tpu_torch as pt
from _torch_port import cuda  # noqa: F401  (fixture)
from _torch_port import one_torch_thread  # noqa: F401  (fixture)
from bench import build_corpus
from divortio_lz4_tpu.ops.linked_xla import encode_linked_scan as jax_scan
from divortio_lz4_tpu_torch.constants import block_bound
from divortio_lz4_tpu_torch.ops.linked_xla import encode_linked_scan

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W = 65536
CORPUS = build_corpus(1 << 20, 7)


def _inputs(rows, bs, dictionary=None, left_noise=False):
    """(blocks u8[nb, bs], lens i32[nb], window u8[W], filled)."""
    blocks = np.zeros((len(rows), bs), np.uint8)
    lens = np.array([len(r) for r in rows], np.int32)
    for i, r in enumerate(rows):
        blocks[i, :len(r)] = r
    window = np.zeros(W, np.uint8)
    if left_noise:
        window[:] = np.random.default_rng(5).integers(0, 256, W)
    filled = 0
    if dictionary is not None:
        window[W - len(dictionary):] = dictionary
        filled = len(dictionary)
    return blocks, lens, window, filled


def _cut(lengths, at=0):
    bounds = np.cumsum([at] + list(lengths))
    return [CORPUS[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


CASES = {
    "3x64k": dict(rows=_cut([W] * 3), bs=W),
    "dict_40k_noise_left": dict(rows=_cut([W] * 3), bs=W,
                                dictionary=CORPUS[500_000: 540_960],
                                left_noise=True),
    "uneven_empty_middle": dict(rows=_cut([1000, 39_000, 0, 13, 65_536, 7]),
                                bs=W, dictionary=CORPUS[600_000: 640_960],
                                left_noise=True),
    "2x256k": dict(rows=_cut([262_144, 137_856]), bs=262_144),
    "no_fingerprints": dict(rows=_cut([W, 20_000], at=W), bs=W, fp=False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_encode_linked_scan_matches_jax(name):
    case = dict(CASES[name])
    fp = case.pop("fp", True)
    bs = case["bs"]
    blocks, lens, window, filled = _inputs(**case)
    jo, jl = jax_scan(jnp.asarray(blocks), jnp.asarray(lens),
                      jnp.asarray(window), jnp.int32(filled), bs, fp)
    jo, jl = np.asarray(jo), np.asarray(jl)
    out, out_lens = encode_linked_scan(
        torch.from_numpy(blocks), torch.from_numpy(lens),
        torch.from_numpy(window), filled, bs, fp)
    assert out.dtype == torch.uint8 and out_lens.dtype == torch.int64
    assert tuple(out.shape) == (len(lens), block_bound(bs))
    np.testing.assert_array_equal(out_lens.numpy(), jl)
    for i, n in enumerate(jl):
        np.testing.assert_array_equal(out[i, :n].numpy(),
                                      jo[i, :n].astype(np.uint8))
        assert not out[i, n:].any()
    assert (jl[lens == 0] == 0).all()


def test_encode_linked_scan_no_rows():
    blocks = np.zeros((0, W), np.uint8)
    lens = np.zeros(0, np.int32)
    window = np.zeros(W, np.uint8)
    jo, jl = jax_scan(jnp.asarray(blocks), jnp.asarray(lens),
                      jnp.asarray(window), jnp.int32(0), W)
    out, out_lens = encode_linked_scan(torch.from_numpy(blocks),
                                       torch.from_numpy(lens),
                                       torch.from_numpy(window), 0, W)
    assert tuple(out.shape) == tuple(np.asarray(jo).shape) \
        == (0, block_bound(W))
    assert out_lens.shape == (0,) and np.asarray(jl).shape == (0,)


def test_encode_linked_scan_rejects_bad_shapes():
    blocks = torch.zeros((2, W), dtype=torch.uint8)
    lens = torch.tensor([W, 5])
    with pytest.raises(ValueError, match="block_size"):
        encode_linked_scan(blocks, lens, torch.zeros(W), 0, 2 * W)
    with pytest.raises(ValueError, match="init_window"):
        encode_linked_scan(blocks, lens, torch.zeros(W - 1), 0, W)


def test_encode_linked_scan_equals_the_xla_frame():
    """Rows equal the compressed blocks of the port's linked 64 KB
    engine="xla" frame; where the frame stored a block (its last, random
    bytes), the row's out_len is what the frame's rule stores: 0 or not
    smaller than the block."""
    noise = np.random.default_rng(9).integers(0, 256, 12_345, np.uint8)
    rows = _cut([W] * 3) + [noise]
    x = np.concatenate(rows)
    cfg = pt.FrameConfig(block_size=W, block_independence=False)
    frame = pt.compress_frame(x, cfg, engine="xla", device="cpu")
    _, blocks, _ = pt.parallel.parse_block_index(frame)
    b, lens, window, _ = _inputs(rows, W)
    out, out_lens = encode_linked_scan(torch.from_numpy(b),
                                       torch.from_numpy(lens),
                                       torch.from_numpy(window), 0, W)
    assert [st for _, _, st in blocks] == [False, False, False, True]
    for i, (off, size, stored) in enumerate(blocks):
        n = int(out_lens[i])
        if stored:
            assert not 0 < n < len(rows[i])
        else:
            assert n == size
            np.testing.assert_array_equal(out[i, :n].numpy(),
                                          frame[off: off + size])


@pytest.mark.cuda
def test_cuda_encode_linked_scan_equals_cpu(cuda):
    """On the card: the uneven rows and the 256 KB rows equal the CPU
    rows element for element."""
    for name in ("uneven_empty_middle", "2x256k"):
        case = dict(CASES[name])
        bs = case["bs"]
        blocks, lens, window, filled = _inputs(**case)
        args = [torch.from_numpy(blocks), torch.from_numpy(lens),
                torch.from_numpy(window)]
        want = encode_linked_scan(*args, filled, bs)
        got = encode_linked_scan(*[a.to(cuda) for a in args], filled, bs)
        assert got[0].is_cuda
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
