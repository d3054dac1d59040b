"""The port's counterparts of the JAX package's remaining public names,
held against the JAX package on the CPU (tolerance: exact bytes).

- ``encode_block_pallas_host`` / ``decode_block_pallas_host``: the
  one-block numpy entry points of the greedy encode and token decode
  kernels (their plain versions here; JAX's Pallas kernels in interpret
  mode), with and without history, and on the card once each.
- ``parallel.device_compress_frame(s)`` / ``device_decompress_frame(s)``:
  JAX's bytes for JAX's default arguments; JAX's callable hooks raise.
- ``chain_select_serialize`` on ``build_chains``' packed i32 chains, with
  and without a partial dictionary: JAX's bytes.
- The package-level names: ``__version__``, ``parse_block_index``,
  ``ops.compress_block_ref`` / ``decompress_block_ref``, ``hybrid_max_bs``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import divortio_lz4_tpu as lz4
import divortio_lz4_tpu_torch as pt
from _torch_port import cuda  # noqa: F401  (fixture)
from _torch_port import one_torch_thread  # noqa: F401  (fixture)
from bench import build_corpus
from divortio_lz4_tpu.ops import hybrid_encode as jax_he
from divortio_lz4_tpu.ops import split_encode as jax_se
from divortio_lz4_tpu.ops.pallas_decode import \
    decode_block_pallas_host as jax_decode_host
from divortio_lz4_tpu.ops.pallas_encode import \
    encode_block_pallas_host as jax_encode_host
from divortio_lz4_tpu.parallel import device as jax_dev
from divortio_lz4_tpu_torch import parallel as pt_parallel
from divortio_lz4_tpu_torch.ops import split_encode as pt_se
from divortio_lz4_tpu_torch.ops.greedy_encode import (encode_block_pallas_host,
                                                      encode_blocks_pallas)
from divortio_lz4_tpu_torch.ops.token_decode import (decode_block_pallas_host,
                                                     decode_blocks_pallas)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W = 65536
CORPUS = build_corpus(1 << 20, 11)
RNG = np.random.default_rng(13)

BLOCKS = {
    "empty": (np.zeros(0, np.uint8), None),
    "short": (np.frombuffer(b"abc", np.uint8), None),
    "json": (np.frombuffer(b'{"a":1,"bb":"xyz"}' * 300, np.uint8), None),
    "random": (RNG.integers(0, 256, 2000, dtype=np.uint8), None),
    "corpus_4k_block": (CORPUS[:3000], 4096),
    "corpus_20k": (CORPUS[100_000: 120_000], None),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_encode_block_pallas_host_matches_jax(name):
    data, bs = BLOCKS[name]
    want = jax_encode_host(data, bs)
    got = encode_block_pallas_host(data, bs, device="cpu")
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("history", [None, "empty", "40k", "100k"])
def test_decode_block_pallas_host_matches_jax(history):
    """A block encoded against a history (the host encoder's dictionary
    path) decodes to the JAX bytes; history=None and an empty history
    decode without one."""
    data = CORPUS[300_000: 330_000]
    hist = {None: None, "empty": np.zeros(0, np.uint8),
            "40k": CORPUS[200_000: 240_960],
            "100k": CORPUS[150_000: 250_000]}[history]
    comp = pt.compress_raw(data) if hist is None or not len(hist) \
        else _encode_with_history(data, hist)
    want = jax_decode_host(np.asarray(comp), len(data), hist)
    got = decode_block_pallas_host(np.asarray(comp), len(data), hist,
                                   device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data)


def _encode_with_history(data, hist):
    """One block encoded with the last 64 KB of *hist* as its dictionary,
    by the host encoder (the JAX package's, as tests/test_pallas_decode.py
    does)."""
    from divortio_lz4_tpu.backends import get_backend
    from divortio_lz4_tpu.constants import block_bound
    from divortio_lz4_tpu.ops.block_ref import new_hash_table
    h = np.asarray(hist[-W:], np.uint8)
    be = get_backend()
    combined = np.concatenate([h, data])
    table = new_hash_table()
    be.warm_table(table, combined, len(h))
    out = np.empty(block_bound(len(data)), np.uint8)
    n = be.compress_block(combined, out, len(h), len(data), table, 0)
    return out[:n]


def test_decode_block_pallas_host_on_truncated_block():
    """A cut stream gives JAX's clamped bytes; nothing raises."""
    comp = np.asarray(pt.compress_raw(CORPUS[:20_000]))[:5_000]
    want = jax_decode_host(comp, 20_000)
    got = decode_block_pallas_host(comp, 20_000, device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_cuda_block_helpers_launch_once(cuda):
    data = CORPUS[:60_000]
    n0 = encode_blocks_pallas.launches
    comp = encode_block_pallas_host(data, device=cuda)
    assert encode_blocks_pallas.launches == n0 + 1
    np.testing.assert_array_equal(comp, pt.compress_raw(data))
    hist = CORPUS[100_000: 140_960]
    for h in (None, hist):
        c = comp if h is None else _encode_with_history(data, h)
        n0 = decode_blocks_pallas.launches
        out = decode_block_pallas_host(c, len(data), h, device=cuda)
        assert decode_blocks_pallas.launches == n0 + 1
        np.testing.assert_array_equal(out, data)


# -- the JAX-named device codec --------------------------------------------

X = CORPUS[:70_000]


def test_device_compress_frame_jax_defaults():
    want = jax_dev.device_compress_frame(X)
    got = pt_parallel.device_compress_frame(X, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        pt_parallel.device_decompress_frame(got, device="cpu"),
        jax_dev.device_decompress_frame(want))


def test_device_frames_jax_defaults():
    datas = [X[:30_000], X[30_000:]]
    want = jax_dev.device_compress_frames(datas)
    got = pt_parallel.device.device_compress_frames(datas, device="cpu")
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    back = pt_parallel.device.device_decompress_frames(got, device="cpu")
    for b, w in zip(back, jax_dev.device_decompress_frames(want),
                    strict=True):
        np.testing.assert_array_equal(b, w)


@pytest.mark.parametrize("hook", ["encode_batch", "decode_batch",
                                  "split_sharded"])
def test_device_frame_hooks_raise(hook):
    fn = pt_parallel.device_compress_frame if hook == "encode_batch" \
        else pt_parallel.device_decompress_frame
    arg = X[:100] if hook == "encode_batch" else lz4.compress(X[:100])
    with pytest.raises(ValueError, match="ShardedCodec"):
        fn(arg, **{hook: lambda *a: None}, device="cpu")


# -- packed chains ---------------------------------------------------------

def _packed_case(k: int):
    """[history | payload] rows of 4 KB payloads: k = 0 no history; else a
    partial dictionary (zeros left of hist_start) before low-entropy
    data starting with zeros."""
    rng = np.random.default_rng(k)
    bs = 4096
    if k == 0:
        return CORPUS[400_000: 400_000 + bs].copy(), 0, 0
    hist = np.zeros(W, np.uint8)
    dlen = 3000
    hist[W - dlen:] = rng.integers(0, 4 if k % 2 else 256, dlen)
    pay = np.concatenate([np.zeros(40 + 7 * k, np.uint8),
                          rng.integers(0, 3, bs - 40 - 7 * k)
                          .astype(np.uint8)])
    return np.concatenate([hist, pay]), W, W - dlen


@pytest.mark.parametrize("k", range(4))
def test_chain_select_serialize_packed_chain_matches_jax(k):
    work, hist_len, hist_start = _packed_case(k)
    n = len(work) - hist_len
    chain = np.asarray(jax_he.build_chains(
        jnp.asarray(work[None].astype(np.int32)),
        jnp.asarray([n], jnp.int32), hist_len,
        jnp.asarray([hist_start], jnp.int32)))[0]
    assert chain.dtype == np.int32
    padded = np.concatenate([work, np.zeros(8, np.uint8)])
    want = jax_se.chain_select_serialize(padded, hist_len, n, chain)
    got = pt_se.chain_select_serialize(padded, hist_len, n, chain)
    np.testing.assert_array_equal(got, want)


# -- package-level names ---------------------------------------------------

def test_package_level_names():
    from divortio_lz4_tpu_torch import ops as pt_ops
    from divortio_lz4_tpu_torch.ops import block_ref as pt_ref
    assert pt.__version__ == lz4.__version__
    assert pt_ops.compress_block_ref is pt_ref.compress_block_ref
    assert pt_ops.decompress_block_ref is pt_ref.decompress_block_ref
    assert pt_se.hybrid_max_bs() == jax_se.hybrid_max_bs() == W
    frame = lz4.compress(X, config=lz4.FrameConfig(block_size=W))
    want = jax_dev.parse_block_index(np.asarray(frame))
    got = pt_parallel.parse_block_index(np.asarray(frame))
    assert got == want
