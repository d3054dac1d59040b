"""The torch port's frame codec held against the JAX package on the CPU.

Frames from divortio_lz4_tpu_torch.compress_frame must be byte-identical to
the JAX device_compress_frame(engine="split"); decompress_frame must equal
the JAX device_decompress_frame(engine="split") and the plaintext, on those
frames and on the golden spec frames (linked ones included), and raise the
same errors on malformed frames. Tolerance: exact everywhere. Block sizes
over 64 KB and linked frames are held against JAX in
tests/test_torch_bigblock.py and tests/test_torch_wave.py.
"""

import ast
import dataclasses
import glob
import itertools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import divortio_lz4_tpu as lz4
import divortio_lz4_tpu_torch as pt
import test_golden as golden
from _torch_port import cuda, mixed_payload  # noqa: F401  (cuda: fixture)
from _torch_port import one_torch_thread  # noqa: F401  (fixture)
from divortio_lz4_tpu.config import FrameConfig
from divortio_lz4_tpu.parallel.device import (device_compress_frame,
                                              device_decompress_frame)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = FrameConfig(block_size=65536, block_independence=True)
VARIANTS = {
    "content_checksum": (CFG.with_(content_checksum=True), False),
    "block_checksums": (CFG.with_(block_checksums=True), False),
    "no_content_size": (CFG.with_(content_size=False), False),
    "dictionary": (CFG.with_(content_checksum=True), True),
}


def _data_and_dict(seed=7):
    data = mixed_payload(150_000, seed)
    return data, np.array(data[1000:10000])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_frame_roundtrip_matches_jax(variant):
    cfg, use_dict = VARIANTS[variant]
    data, d = _data_and_dict()
    d = d if use_dict else None
    want = np.asarray(device_compress_frame(data, cfg, dictionary=d,
                                            engine="split"))
    got = pt.compress_frame(data, cfg, dictionary=d, device="cpu")
    assert got.tobytes() == want.tobytes()
    ref = np.asarray(device_decompress_frame(want, dictionary=d,
                                             engine="split"))
    out = pt.decompress_frame(got, dictionary=d, device="cpu")
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, data)
    # the host C++ codec decodes the port's frame too
    np.testing.assert_array_equal(
        np.asarray(lz4.decompress(got, dictionary=d)), data)


@pytest.mark.parametrize("payload", [b"", b"Hello World", b"ab" * 40000],
                         ids=["empty", "hello", "two_blocks_rle"])
def test_small_frames_match_jax(payload):
    cfg = CFG.with_(content_size=False)
    want = np.asarray(device_compress_frame(payload, cfg, engine="split"))
    got = pt.compress_frame(payload, cfg, device="cpu")
    assert got.tobytes() == want.tobytes()
    assert pt.decompress_frame(got, device="cpu").tobytes() == payload
    if payload == b"Hello World":
        assert got.tobytes() == bytes.fromhex(golden.GOLDEN_HELLO)


GOLDEN_INDEPENDENT = {
    "hello": (golden.GOLDEN_HELLO, b"Hello World"),
    "empty_4mb": (golden.GOLDEN_EMPTY_4MB, b""),
    "hello_ck": (golden.GOLDEN_HELLO_CK, b"Hello World"),
    "multiblock": (golden.GOLDEN_MULTIBLOCK, b"A" * 131072),
    "block_ck": (golden.GOLDEN_BLOCK_CK, b"Hello World"),
    "mixed_stored": (golden.GOLDEN_MIXED_STORED,
                     b"A" * 65536 + b"incompressible tail bytes!!"),
    "content_size": (golden.GOLDEN_CONTENT_SIZE, b"Hello World"),
}


@pytest.mark.parametrize("name", list(GOLDEN_INDEPENDENT))
def test_golden_frames_decode(name):
    hexs, plain = GOLDEN_INDEPENDENT[name]
    frame = golden.from_hex(hexs)
    out = pt.decompress_frame(frame, device="cpu")
    assert out.tobytes() == plain
    ref = np.asarray(device_decompress_frame(frame, engine="split"))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("name", ["linked_xblock", "dict_linked"])
def test_golden_linked_frames_decode(name):
    hexs, dic, plain = {
        "linked_xblock": (golden.GOLDEN_LINKED_XBLOCK, None,
                          golden.GOLDEN_LINKED_PLAINTEXT),
        "dict_linked": (golden.GOLDEN_DICT, golden.GOLDEN_DICT_DICTIONARY,
                        golden.GOLDEN_DICT_PLAINTEXT)}[name]
    frame = golden.from_hex(hexs)
    out = pt.decompress_frame(frame, dictionary=dic, device="cpu")
    assert out.tobytes() == plain
    ref = np.asarray(device_decompress_frame(frame, dictionary=dic,
                                             engine="split"))
    np.testing.assert_array_equal(out, ref)


def _corrupt(kind):
    """(frame, dictionary) for one malformed-frame case."""
    data, d = _data_and_dict(seed=8)
    data = data[:70_000]
    if kind in ("no_dictionary", "wrong_dictionary"):
        frame = np.array(lz4.compress(data, dictionary=d, config=CFG))
        return frame, (None if kind == "no_dictionary"
                       else np.frombuffer(b"not-the-dict" * 30, np.uint8))
    cfg = CFG.with_(content_checksum=True, block_checksums=True)
    frame = np.array(lz4.compress(data, config=cfg))
    if kind == "bad_magic":
        frame[0] ^= 0x01
    elif kind == "header_checksum":
        frame[14] ^= 0xFF          # 4 magic + FLG + BD + 8 size -> HC
    elif kind == "content_checksum":
        frame[-1] ^= 0xFF
    elif kind == "block_checksum":
        frame[20] ^= 0x01          # first block's data
    elif kind == "truncated":
        frame = frame[: len(frame) - 9]
    elif kind == "no_endmark":
        frame = frame[: len(frame) - 8]
    return frame, None


@pytest.mark.parametrize("kind", [
    "bad_magic", "header_checksum", "content_checksum", "block_checksum",
    "no_dictionary", "wrong_dictionary", "truncated", "no_endmark"])
def test_errors_match_jax(kind):
    frame, dic = _corrupt(kind)
    with pytest.raises(ValueError) as ref:
        device_decompress_frame(frame, dictionary=dic, engine="split")
    with pytest.raises(ValueError) as got:
        pt.decompress_frame(frame, dictionary=dic, device="cpu")
    assert str(got.value) == str(ref.value)
    assert str(got.value).startswith("LZ4: ")
    with pytest.raises(ValueError) as many:
        pt.decompress_frames([frame], dictionary=dic, device="cpu")
    assert str(many.value) == str(ref.value)


def test_frames_in_flight_keep_order():
    data, _ = _data_and_dict(seed=9)
    datas = [data[:100_000], b"", data[100_000:], b"xyz" * 30000]
    cfg = CFG.with_(content_checksum=True)
    frames = pt.compress_frames(datas, cfg, device="cpu")
    assert len(frames) == len(datas)
    for f, x in zip(frames, datas):
        assert f.tobytes() == pt.compress_frame(x, cfg,
                                                device="cpu").tobytes()
    # frames of other configurations decode in the same batch
    frames.append(pt.compress_frame(data, cfg.with_(block_checksums=True),
                                    device="cpu"))
    frames.append(np.asarray(lz4.compress(data[:5000], config=CFG)))
    outs = pt.decompress_frames(frames, device="cpu")
    want = [bytes(x) for x in datas] + [data.tobytes(),
                                        data[:5000].tobytes()]
    assert [o.tobytes() for o in outs] == want


@pytest.mark.usefixtures("one_torch_thread")
def test_unsupported_configurations_raise():
    """Every engine and route the JAX package has is served (the xla
    engine both ways and hybrid decode, which used to raise, now equal
    JAX's bytes); what JAX does not have raises: an engine name it lacks,
    an assemble mode other than host or device."""
    data = np.zeros(1000, np.uint8)
    for engine in ("hybrid", "xla"):
        frame = pt.compress_frame(data, CFG, engine=engine, device="cpu")
        assert frame.tobytes() == np.asarray(device_compress_frame(
            data, CFG, engine=engine)).tobytes()
    for engine in ("xla", "hybrid"):
        np.testing.assert_array_equal(
            pt.decompress_frame(lz4.compress(data), engine=engine,
                                device="cpu"),
            np.asarray(device_decompress_frame(lz4.compress(data),
                                               engine=engine)))
    with pytest.raises(ValueError, match="no engine='wave'"):
        pt.compress_frame(data, CFG, engine="wave", device="cpu")
    with pytest.raises(ValueError, match="no engine='wave'"):
        pt.decompress_frame(frame, engine="wave", device="cpu")
    with pytest.raises(ValueError, match="assemble='chip'"):
        pt.compress_frame(data, CFG, engine="xla", assemble="chip",
                          device="cpu")
    # the default configuration (4 MB linked blocks) is ported
    frame = pt.compress_frame(data, FrameConfig(), device="cpu")
    assert frame.tobytes() == np.asarray(device_compress_frame(
        data, FrameConfig(), engine="split")).tobytes()
    np.testing.assert_array_equal(pt.decompress_frame(frame, device="cpu"),
                                  data)


# Every (engine, configuration) the JAX device_compress_frame /
# device_decompress_frame accepts and the port used to refuse.
JAX_ROUTES = {
    "xla_encode": ("xla", CFG, False),
    "xla_linked_encode": ("xla", FrameConfig(block_size=65536), False),
    "pallas_dictionary": ("pallas", CFG, True),
    "pallas_linked": ("pallas", FrameConfig(block_size=65536), False),
    "hybrid_linked_block_checksums": (
        "hybrid", FrameConfig(block_size=65536, block_checksums=True), True),
}


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("route", list(JAX_ROUTES))
def test_every_jax_engine_route_is_served(route):
    """Each route encodes to JAX's bytes, and decodes on the same engine
    to JAX's bytes (the pallas decode and the XLA decode behind hybrid)."""
    engine, cfg, use_dict = JAX_ROUTES[route]
    data, d = _data_and_dict(seed=11)
    d = d if use_dict else None
    want = np.asarray(device_compress_frame(data, cfg, dictionary=d,
                                            engine=engine))
    got = pt.compress_frame(data, cfg, dictionary=d, engine=engine,
                            device="cpu")
    assert got.tobytes() == want.tobytes()
    out = pt.decompress_frame(got, dictionary=d, engine=engine, device="cpu")
    ref = np.asarray(device_decompress_frame(want, dictionary=d,
                                             engine=engine))
    assert out.tobytes() == ref.tobytes() == data.tobytes()


def test_device_is_explicit():
    with pytest.raises(TypeError, match="device is required"):
        pt.compress_frame(b"abc", CFG, device=None)
    with pytest.raises(ValueError, match="unsupported device"):
        pt.decompress_frame(b"abc", device="meta")


def test_cuda_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error cannot show")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        pt.compress_frame(b"abc", CFG, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        pt.decompress_frames([], device="cuda")


def test_default_device_is_cuda():
    """Entry points run on the card unless the caller asks for the CPU:
    without a GPU the default raises, it does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error cannot show")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        pt.compress_frame(b"abc", CFG)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        pt.decompress_frames([lz4.compress(b"abc")], engine="pallas")


def test_import_leaves_jax_out():
    """The port never imports jax or the JAX package, not even its host
    modules: checked in a fresh interpreter (this test process has jax
    loaded by the suite's conftest) after a CPU round trip on both
    engines, a hybrid encode, a placed-literal block decode, a stream
    round trip with device bursts and a ShardedCodec round trip on both
    of its engines."""
    code = "\n".join([
        "import sys, numpy as np, divortio_lz4_tpu_torch as pt",
        "data = np.frombuffer(b'port round trip ' * 5000, np.uint8)",
        "cfg = pt.FrameConfig(block_size=65536, block_independence=True,",
        "                     content_checksum=True)",
        "for engine in ('split', 'pallas'):",
        "    f = pt.compress_frame(data, cfg, engine=engine, device='cpu')",
        "    out = pt.decompress_frame(f, engine=engine, device='cpu')",
        "    assert out.tobytes() == data.tobytes(), engine",
        "f = pt.compress_frame(data, cfg, engine='hybrid', device='cpu')",
        "assert pt.decompress_frame(f, device='cpu').tobytes() == "
        "data.tobytes()",
        "from divortio_lz4_tpu_torch.ops import split_decode as sd",
        "from divortio_lz4_tpu_torch.parallel.device import "
        "parse_block_index",
        "(o, n, stored), *_ = parse_block_index(f)[1]",
        "assert not stored",
        "out = sd.decode_block_split_host(f[o: o + n], 65536, device='cpu')",
        "assert out.tobytes() == data[:65536].tobytes()",
        "enc = pt.LZ4Encoder(cfg, device='cpu')",
        "big = np.tile(data, 4)   # 4 full blocks: one burst each way",
        "f = b''.join(enc.add(big)) + b''.join(enc.finish())",
        "dec = pt.LZ4Decoder(device='cpu')",
        "assert b''.join(map(bytes, dec.update(f))) == big.tobytes()",
        "assert enc.stats['device_blocks'] and dec.stats['device_blocks']",
        "for engine in ('xla', 'best'):",
        "    c = pt.parallel.ShardedCodec(['cpu'] * 2, engine=engine)",
        "    assert c.decompress(c.compress(data)).tobytes() == "
        "data.tobytes()",
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in",
        "             ('jax', 'jaxlib', 'divortio_lz4_tpu'))",
        "assert not bad, bad",
    ])
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=300)


def _port_sources():
    files = sorted(glob.glob(os.path.join(REPO, "divortio_lz4_tpu_torch",
                                          "**", "*.py"), recursive=True))
    return files + [os.path.join(REPO, name) for name in
                    ("chip_smoke.py", "chip_breakdown.py",
                     "chip_decode_steps.py",
                     os.path.join("examples", "12_torch_device.py"))]


def test_port_sources_import_no_jax():
    """No module of the port, nor the chip_*.py scripts at the root, nor
    the port's device example, imports jax or the JAX package, anywhere
    in the file (an AST scan, so imports inside functions count too)."""
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib",
                                          "divortio_lz4_tpu"):
                    bad.append(f"{os.path.relpath(path, REPO)}:"
                               f"{node.lineno} {name}")
    assert len(_port_sources()) > 20
    assert not bad, bad


BLOCK_SIZES = [None, 0, 1, 65535, 65536, 65537, 262144, 262145, 1048576,
               1048577, 4194304, 4194305, 1 << 30]


@pytest.mark.parametrize("block_size", BLOCK_SIZES)
def test_frame_config_matches_jax(block_size):
    """The port's FrameConfig (its own copy) resolves every block size and
    flag combination as the JAX package's does."""
    for flags in itertools.product([False, True], repeat=4):
        kw = dict(zip(("block_independence", "content_checksum",
                       "content_size", "block_checksums"), flags))
        a = pt.FrameConfig(block_size=block_size, **kw)
        b = FrameConfig(block_size=block_size, **kw)
        assert (a.block_id, a.resolved_block_size) == \
            (b.block_id, b.resolved_block_size)
        assert dataclasses.asdict(a.with_(favor_ratio=False)) == \
            dataclasses.asdict(b.with_(favor_ratio=False))
    assert dataclasses.asdict(pt.FrameConfig()) == \
        dataclasses.asdict(FrameConfig())


@pytest.mark.cuda
def test_cuda_frames_match_cpu(cuda):
    data, d = _data_and_dict()
    for cfg, use_dict in VARIANTS.values():
        dic = d if use_dict else None
        want = pt.compress_frame(data, cfg, dictionary=dic, device="cpu")
        got = pt.compress_frame(data, cfg, dictionary=dic, device=cuda)
        assert got.tobytes() == want.tobytes()
        out = pt.decompress_frame(got, dictionary=dic, device=cuda)
        np.testing.assert_array_equal(out, data)
