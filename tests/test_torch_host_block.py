"""The port's host block codec and streaming xxHash32 held against the JAX
package on the CPU.

compress_block / decompress_block of the port's "native" (its own C++) and
"python" (its copy of the oracle) backends must give the bytes, lengths and
"LZ4: ..." errors of the JAX package's native and python backends, on the
same numpy-made inputs, with and without history. The streaming XXHash32
must give JAX's digests and the same state_dict (checkpoints carry it).
Tolerance: exact everywhere.
"""

import pickle

import numpy as np
import pytest

import divortio_lz4_tpu  # noqa: F401  (registers the JAX native backend)
import divortio_lz4_tpu.backends as jb
import divortio_lz4_tpu.xxh as jx
import divortio_lz4_tpu_torch.backends as pb
import divortio_lz4_tpu_torch.xxh as px
from _torch_port import mixed_payload
from divortio_lz4_tpu.constants import block_bound

BACKENDS = ["native", "python"]


def _inputs():
    """(name, payload, history) cases: mixed 64 KB payloads, small and
    empty blocks, RLE, random bytes, and blocks with a history."""
    rng = np.random.default_rng(0x10C)
    mixed = mixed_payload(120_000, 3)
    return [
        ("mixed_64k", mixed[:65536], None),
        ("json_40k", mixed[:40_000], None),
        ("random", rng.integers(0, 256, 9000).astype(np.uint8), None),
        ("rle", np.full(30_000, 7, np.uint8), None),
        ("tiny", np.frombuffer(b"Hello World", np.uint8), None),
        ("short_12", np.frombuffer(b"abcdabcdabcd", np.uint8), None),
        ("empty", np.empty(0, np.uint8), None),
        ("with_history", mixed[65536:100_000], mixed[:65536]),
        ("short_history", mixed[70_000:90_000], mixed[60_000:61_000]),
    ]


CASES = {name: (x, h) for name, x, h in _inputs()}


def _compress(be, payload, hist):
    hist = np.empty(0, np.uint8) if hist is None else hist
    working = np.concatenate([hist, payload]).astype(np.uint8)
    table = np.zeros(1 << 14, np.int32)
    if len(hist):
        be.warm_table(table, working, len(hist))
    out = np.zeros(4 + block_bound(len(payload)) + 4, np.uint8)
    n = be.compress_block(working, out, len(hist), len(payload), table, 4)
    return out[4: 4 + n].tobytes(), table


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", list(CASES))
def test_compress_block_matches_jax(backend, case):
    payload, hist = CASES[case]
    want, want_table = _compress(jb.get_backend(backend), payload, hist)
    got, got_table = _compress(pb.get_backend(backend), payload, hist)
    assert got == want
    np.testing.assert_array_equal(got_table, want_table)
    # and the two port backends agree with each other
    assert got == _compress(pb.get_backend("python"), payload, hist)[0]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", list(CASES))
def test_decompress_block_matches_jax(backend, case):
    payload, hist = CASES[case]
    comp = np.frombuffer(_compress(jb.get_backend("native"), payload,
                                   hist)[0], np.uint8)
    results = []
    for be in (jb.get_backend(backend), pb.get_backend(backend)):
        dst = np.zeros(len(payload) + 64, np.uint8)
        n = be.decompress_block(comp, 0, len(comp), dst, 0, hist)
        results.append(dst[:n].tobytes())
    assert results[0] == results[1] == payload.tobytes()


def _hostile_blocks():
    rng = np.random.default_rng(0xBAD)
    good = np.frombuffer(_compress(jb.get_backend("native"),
                                   mixed_payload(20_000, 5)[:20_000],
                                   None)[0], np.uint8)
    blocks = {"truncated": good[: len(good) // 2],
              "offset_zero": np.array([0x14, 0x41, 0x00, 0x00], np.uint8),
              "before_start": np.array([0x14, 0x41, 0x05, 0x00, 0x00],
                                       np.uint8),
              "long_literal_run": np.array([0xF0, 255, 255], np.uint8)}
    for i in range(6):
        b = good.copy()
        b[rng.integers(0, len(b), 3)] = rng.integers(0, 256, 3)
        blocks[f"mutated_{i}"] = b
    return blocks


HOSTILE = _hostile_blocks()


def _decode_or_error(be, comp, cap, hist):
    dst = np.zeros(cap, np.uint8)
    try:
        n = be.decompress_block(comp, 0, len(comp), dst, 0, hist)
    except (ValueError, IndexError) as e:
        return f"{type(e).__name__}: {e}"
    return dst[:n].tobytes()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", list(HOSTILE))
def test_hostile_block_errors_match_jax(backend, case):
    """Broken blocks raise JAX's "LZ4: ..." error, or decode to JAX's
    bytes, with a small output buffer and with a dictionary."""
    comp = HOSTILE[case]
    d = np.frombuffer(b"dictionary-bytes" * 8, np.uint8)
    for cap, hist in ((65536, None), (100, None), (65536, d)):
        want = _decode_or_error(jb.get_backend(backend), comp, cap, hist)
        got = _decode_or_error(pb.get_backend(backend), comp, cap, hist)
        assert got == want, (cap, hist is None)


def test_backend_registry_matches_jax():
    assert pb.available_backends() == ["native", "python"]
    assert set(pb.available_backends()) <= set(jb.available_backends())
    assert pb.get_backend().name == jb.get_backend().name == "native"
    for mod in (jb, pb):
        with pytest.raises(KeyError, match="LZ4: unknown backend 'gpu'"):
            mod.get_backend("gpu")


def _feeds():
    rng = np.random.default_rng(0x5EED)
    data = mixed_payload(50_000, 11)
    cuts = np.sort(rng.integers(0, len(data), 40))
    return data, [data[a:b] for a, b in zip(np.r_[0, cuts], np.r_[cuts,
                                                                  len(data)])]


@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF])
def test_streaming_xxhash_matches_jax(seed):
    """Digests after every fragment (empty, 1-byte, odd and aligned ones),
    state_dict after every fragment, and a pickled resume mid-stream."""
    data, parts = _feeds()
    parts = [np.empty(0, np.uint8), data[:1], data[1:17]] + parts
    hj, hp = jx.XXHash32(seed), px.XXHash32(seed)
    for i, part in enumerate(parts):
        hj.update(part)
        hp.update(part)
        assert hp.digest() == hj.digest()
        assert hp.state_dict() == hj.state_dict()
        if i == len(parts) // 2:
            # a snapshot moves between the packages either way
            hp = px.XXHash32.from_state(pickle.loads(pickle.dumps(
                hj.state_dict())))
            hj = jx.XXHash32.from_state(hp.state_dict())
    assert hp.digest() == px.xxhash32(np.concatenate(parts), seed) \
        == jx.xxhash32(np.concatenate(parts), seed)
    hp.reset()
    assert hp.digest() == jx.xxhash32(b"", seed)
