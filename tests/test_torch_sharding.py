"""The port's ShardedCodec held against the JAX package's on the CPU.

The same numpy-made inputs go through JAX's ShardedCodec on the suite's
virtual CPU devices (``make_mesh(n)``; its Pallas kernels in interpret
mode) and the port's over ``["cpu"] * n`` (torch ops and the kernels'
plain versions, each shard on its own device entry). Frames must be
byte-identical (tolerance 0) on both engines, "xla" and "best", and every
frame must decode exactly through both engines' ``decompress`` and the
host codec. The cases are tests/test_sharding.py's, plus fewer blocks than
devices, an empty payload, and a 256 KB-block frame through a codec
configured at 64 KB.
"""

import numpy as np
import pytest
import torch

import divortio_lz4_tpu as lz4
import divortio_lz4_tpu_torch as pt
from _torch_port import cuda, one_torch_thread  # noqa: F401  (fixtures)
from conftest import make_compressible
from divortio_lz4_tpu.config import FrameConfig
from divortio_lz4_tpu.parallel import ShardedCodec as JaxShardedCodec
from divortio_lz4_tpu.parallel import device_compress_frame
from divortio_lz4_tpu.parallel import make_mesh as jax_make_mesh
from divortio_lz4_tpu_torch.parallel import ShardedCodec, make_mesh
from divortio_lz4_tpu_torch.parallel.device import shard_spans

INDEP = FrameConfig(block_size=65536, block_independence=True)
LINKED = FrameConfig(block_size=65536, block_independence=False)


def _codecs(n, config=None, engine="xla"):
    return (JaxShardedCodec(jax_make_mesh(n), config, engine=engine),
            ShardedCodec(["cpu"] * n, config, engine=engine))


def _decoders(config=None):
    """Both engines' decoders over 4 CPU device entries."""
    return [ShardedCodec(["cpu"] * 4, config, engine=e)
            for e in ("xla", "best")]


def _check_frame(got, want, data, dictionary=None, config=None):
    """got == want, and it decodes exactly through both port engines and
    the JAX host codec."""
    assert got.dtype == np.uint8 and got.tobytes() == \
        np.asarray(want).tobytes()
    assert np.asarray(lz4.decompress(got, dictionary=dictionary)) \
        .tobytes() == data.tobytes()
    for codec in _decoders(config):
        assert codec.decompress(got, dictionary=dictionary).tobytes() == \
            data.tobytes(), codec.engine


def test_sharded_codec_roundtrip(one_torch_thread):  # noqa: F811
    """test_sharding.py:76: 5 blocks over 8 devices."""
    jc, pc = _codecs(8)
    data = make_compressible(300_000)
    frame = pc.compress(data)
    _check_frame(frame, jc.compress(data), data)
    out = pc.decompress(frame)
    assert out.tobytes() == np.asarray(jc.decompress(np.array(frame))) \
        .tobytes() == data.tobytes()


def test_sharded_interops_with_host_paths(one_torch_thread):  # noqa: F811
    """test_sharding.py:84: the host codec decodes the sharded frame, the
    sharded codec decodes the host codec's frame (stored blocks too)."""
    jc, pc = _codecs(4)
    data = np.concatenate([make_compressible(200_000),
                           np.random.default_rng(0xD1507).integers(
                               0, 256, 100_000, dtype=np.uint8)])
    frame = pc.compress(data)
    _check_frame(frame, jc.compress(data), data)
    host_frame = np.asarray(lz4.compress(data, config=INDEP))
    assert pc.decompress(host_frame).tobytes() == data.tobytes()


@pytest.mark.parametrize("dictionary", [False, True],
                         ids=["plain", "dictionary"])
def test_sharded_linked(dictionary, one_torch_thread):  # noqa: F811
    """test_sharding.py:97 and :116: linked frames shard at encode time;
    the frame is JAX's sharded and single-device frame, decoded on the
    first device."""
    jc, pc = _codecs(4, LINKED)
    data = make_compressible(300_000 if not dictionary else 200_000)
    d = np.array(data[:8000]) if dictionary else None
    frame = pc.compress(data, dictionary=d)
    _check_frame(frame, jc.compress(data, dictionary=d), data, d, LINKED)
    if not dictionary:
        single = device_compress_frame(data, LINKED)
        assert frame.tobytes() == np.asarray(single).tobytes()
        assert len(frame) <= len(ShardedCodec(["cpu"] * 4).compress(data))
    assert np.asarray(jc.decompress(frame, dictionary=d)).tobytes() == \
        data.tobytes()


@pytest.mark.parametrize("dictionary", [False, True],
                         ids=["plain", "dictionary"])
def test_sharded_best_engine(dictionary, one_torch_thread):  # noqa: F811
    """test_sharding.py:172 and :198: engine="best" (hybrid encoder, split
    decoder) round-trips, matches JAX and the host tier both ways."""
    cfg = FrameConfig(block_size=4096, block_independence=True)
    jc, pc = _codecs(4, cfg, "best")
    assert pc._use_best and jc._use_best
    if dictionary:
        d = make_compressible(9000)
        data = make_compressible(30_000)
    else:
        d = None
        data = np.concatenate([make_compressible(60_000),
                               np.random.default_rng(0xD1507).integers(
                                   0, 256, 9_000, dtype=np.uint8)])
    frame = pc.compress(data, dictionary=d)
    _check_frame(frame, jc.compress(data, dictionary=d), data, d, cfg)
    host_frame = np.asarray(lz4.compress(data, config=cfg, dictionary=d))
    assert pc.decompress(host_frame, dictionary=d).tobytes() == \
        data.tobytes()
    assert np.asarray(jc.decompress(frame, dictionary=d)).tobytes() == \
        data.tobytes()


@pytest.mark.parametrize("engine", ["xla", "best"])
@pytest.mark.parametrize("size", [0, 11, 70_000],
                         ids=["empty", "one_block", "two_blocks"])
def test_fewer_blocks_than_devices(engine, size, one_torch_thread):  # noqa: F811
    """Devices whose shard would hold only padding are skipped; the frame
    is JAX's (an empty payload: a frame with no block)."""
    cfg = INDEP.with_(content_checksum=True)
    jc, pc = _codecs(4, cfg, engine)
    data = make_compressible(size)
    frame = pc.compress(data)
    _check_frame(frame, jc.compress(data), data, config=cfg)


@pytest.mark.parametrize("engine", ["xla", "best"])
def test_wide_frame_through_a_64k_codec(engine, one_torch_thread):  # noqa: F811
    """A 256 KB-block frame decodes through a codec configured at 64 KB:
    the kernels are sized by the frame header's block size. JAX's "best"
    does the same (its "xla" sizes rows by the codec's config and returns
    wrong bytes: a reference quirk the port does not copy)."""
    data = make_compressible(600_000)
    frame = np.asarray(lz4.compress(data, config=FrameConfig(
        block_size=262144, block_independence=True)))
    jc, pc = _codecs(4, engine=engine)
    out = pc.decompress(frame)
    assert out.tobytes() == data.tobytes()
    if engine == "best":
        assert np.asarray(jc.decompress(frame)).tobytes() == data.tobytes()


def test_sharded_checksums_and_host_route(one_torch_thread):  # noqa: F811
    """Block and content checksums on both engines; a linked frame with
    block checksums takes the host frame encoder, as in JAX; the xla
    engine without fingerprints."""
    data = np.concatenate([make_compressible(150_000),
                           np.random.default_rng(3).integers(
                               0, 256, 40_000, dtype=np.uint8)])
    for cfg, engine, fp in (
            (INDEP.with_(block_checksums=True, content_checksum=True),
             "best", True),
            (INDEP.with_(block_checksums=True), "xla", False),
            (LINKED.with_(block_checksums=True), "xla", True)):
        jc = JaxShardedCodec(jax_make_mesh(4), cfg, use_fingerprints=fp,
                             engine=engine)
        pc = ShardedCodec(["cpu"] * 4, cfg, use_fingerprints=fp,
                          engine=engine)
        _check_frame(pc.compress(data), jc.compress(data), data, config=cfg)
    bad = pc.compress(data)
    bad[40] ^= 0xFF
    with pytest.raises(ValueError, match="LZ4: .*Checksum"):
        pc.decompress(bad)


def test_shard_spans_split_like_jax_padding():
    """ceil(n / devices) rows a device, in order; padding-only devices
    left out."""
    devs = ["a", "b", "c", "d"]
    assert shard_spans(5, devs) == [("a", slice(0, 2)), ("b", slice(2, 4)),
                                    ("c", slice(4, 5))]
    assert shard_spans(1, devs) == [("a", slice(0, 1))]
    assert shard_spans(8, devs)[-1] == ("d", slice(6, 8))
    assert [s for _, s in shard_spans(5, devs[:1])] == [slice(0, 5)]


def test_codec_defaults_to_the_cards():
    """ShardedCodec() and make_mesh() take CUDA devices only: without a
    GPU they raise; an unknown engine raises too."""
    with pytest.raises(ValueError, match="no engine='pallas'"):
        ShardedCodec(["cpu"], engine="pallas")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error cannot show")
    with pytest.raises(RuntimeError, match="CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA device"):
        ShardedCodec()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ShardedCodec(["cuda:0"])


@pytest.mark.cuda
def test_cuda_sharded_codec_matches_cpu(cuda, one_torch_thread):  # noqa: F811
    """On the card, one device entry twice: the frames are the CPU's, and
    every frame decodes exactly through both engines."""
    from divortio_lz4_tpu_torch.ops.compact_decode import \
        decode_blocks_compact
    from divortio_lz4_tpu_torch.ops.hybrid_encode import hybrid_walk
    data = np.concatenate([make_compressible(300_000),
                           np.random.default_rng(9).integers(
                               0, 256, 70_000, dtype=np.uint8)])
    assert make_mesh(1) == [torch.device("cuda", 0)]
    for engine in ("xla", "best"):
        card = ShardedCodec([cuda, cuda], engine=engine)
        cpu = ShardedCodec(["cpu", "cpu"], engine=engine)
        hybrid_walk.launches = decode_blocks_compact.launches = 0
        frame = card.compress(data)
        assert frame.tobytes() == cpu.compress(data).tobytes()
        for dec in (card, ShardedCodec([cuda], engine="xla"),
                    ShardedCodec([cuda], engine="best")):
            assert dec.decompress(frame).tobytes() == data.tobytes()
        # "best": 2 shards, then the one-device "best" decoder; "xla": the
        # one-device "best" decoder only
        assert hybrid_walk.launches == (2 if engine == "best" else 0)
        assert decode_blocks_compact.launches == (3 if engine == "best"
                                                  else 1)
    assert pt.parallel.ShardedCodec is ShardedCodec
