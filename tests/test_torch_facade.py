"""The port's host facade held against the JAX package's on the CPU.

``pt.compress`` / ``pt.decompress`` (the host frame codec,
``divortio_lz4_tpu_torch.frame``), ``compress_raw`` / ``decompress_raw``,
the string and object helpers, ``Scheduler``, the async helpers and
streams and ``LZ4Worker`` get the same numpy-made inputs as their JAX
counterparts. Frames, blocks and plaintext must be equal byte for byte,
and every error string letter for letter (tolerance 0). The async and
worker streams run on ``device="cpu"`` with the port's default
``backend="device"``, against JAX's ``backend="device"`` streams.
"""

import asyncio
import os
import subprocess
import sys

import numpy as np
import pytest

import divortio_lz4_tpu as lz4
import divortio_lz4_tpu.aio as jaio
import divortio_lz4_tpu_torch as pt
from _torch_port import mixed_payload
from _torch_port import one_torch_thread  # noqa: F401  (fixture)
from divortio_lz4_tpu.config import FrameConfig
from divortio_lz4_tpu.worker import LZ4Worker as JaxWorker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KB = 1024
DICT = mixed_payload(70_000, 7)

CONFIGS = {
    "64k_indep": FrameConfig(block_size=64 * KB, block_independence=True),
    "64k_linked_ck": FrameConfig(block_size=64 * KB, content_checksum=True),
    "64k_indep_bck_size": FrameConfig(block_size=64 * KB,
                                      block_independence=True,
                                      block_checksums=True,
                                      content_size=True),
    "256k_linked_size": FrameConfig(block_size=256 * KB, content_size=True,
                                    content_checksum=True),
    "1m_indep_all": FrameConfig(block_size=1 << 20, block_independence=True,
                                content_checksum=True, block_checksums=True,
                                content_size=True),
    "4m_default": FrameConfig(),
    "4m_indep_size": FrameConfig(block_independence=True, content_size=True),
    "64k_linked_dict": FrameConfig(block_size=64 * KB, content_checksum=True),
    "64k_indep_dict_size": FrameConfig(block_size=64 * KB,
                                       block_independence=True,
                                       content_size=True),
    "64k_empty": FrameConfig(block_size=64 * KB, content_checksum=True),
    "64k_empty_size": FrameConfig(block_size=64 * KB, content_size=True),
}


def _case(name, backend):
    """(payload, dictionary) of a CONFIGS case: 600 KB on the native
    backend, 150 KB on the Python oracle."""
    n = 0 if "empty" in name else (600_000 if backend == "native"
                                   else 150_000)
    return (mixed_payload(n, len(name)),
            DICT if "dict" in name else None)


def _error(fn):
    try:
        return ("ok", np.asarray(fn()).tobytes())
    except (ValueError, IndexError) as e:
        return (type(e).__name__, str(e))


# -- frame codec ------------------------------------------------------------

@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_compress_matches_jax(name, backend):
    """pt.compress == JAX compress, and each package decodes the other's
    frame (frames with a content size take the direct-write route, those
    without the per-block loop with its rolling window)."""
    cfg = CONFIGS[name]
    data, d = _case(name, backend)
    want = lz4.compress(data, d, cfg, backend=backend)
    got = pt.compress(data, d, cfg, backend=backend)
    assert got.dtype == np.uint8
    assert got.tobytes() == want.tobytes()
    assert pt.decompress(want, d, backend=backend).tobytes() \
        == data.tobytes()
    assert np.asarray(lz4.decompress(got, d, backend=backend)).tobytes() \
        == data.tobytes()


@pytest.mark.parametrize("room", ["body_bound", "per_block"])
@pytest.mark.parametrize("backend", ["native", "python"])
def test_compress_into_output_buffer(room, backend):
    """output_buffer: the frame is a view of the caller's buffer, the
    bytes JAX's. Below the body's bound the native backend takes the
    per-block loop, as in JAX."""
    cfg = CONFIGS["64k_indep_bck_size"].with_(content_checksum=True)
    data = mixed_payload(200_000, 3)
    n, nb = len(data), 4
    body_bound = nb * 8 + n + n // 255 + 16 * nb + 4 + 24
    size = 15 + body_bound + (4 if room == "body_bound" else -1)
    frames = []
    for mod in (lz4, pt):
        buf = np.zeros(size, np.uint8)
        f = mod.compress(data, None, cfg, output_buffer=buf,
                         backend=backend)
        assert np.shares_memory(f, buf)
        frames.append(np.asarray(f).tobytes())
    assert frames[0] == frames[1]
    assert pt.decompress(frames[1]).tobytes() == data.tobytes()


SKIP = b"\x50\x2a\x4d\x18\x05\x00\x00\x00USER!"


@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("name", ["64k_indep", "64k_linked_ck",
                                  "256k_linked_size", "64k_linked_dict",
                                  "64k_indep_dict_size"])
def test_decompress_skippable_prefix(name, backend):
    """Leading skippable frames (two of them) are skipped."""
    data, d = _case(name, backend)
    frame = lz4.compress(data, d, CONFIGS[name]).tobytes()
    stream = np.frombuffer(SKIP + SKIP + frame, np.uint8)
    want = lz4.decompress(stream, d, backend=backend)
    got = pt.decompress(stream, d, backend=backend)
    assert got.tobytes() == np.asarray(want).tobytes() == data.tobytes()


def _corruptions():
    data = mixed_payload(300_000, 11)
    ind = lz4.compress(data, None, FrameConfig(
        block_size=64 * KB, block_independence=True, content_checksum=True,
        block_checksums=True, content_size=True)).tobytes()
    lnk = lz4.compress(data, None, FrameConfig(
        block_size=64 * KB, content_checksum=True,
        block_checksums=True)).tobytes()
    dic = lz4.compress(data[:100_000], DICT, FrameConfig(
        block_size=64 * KB, content_size=True)).tobytes()

    def flip(f, at, bit=1):
        b = bytearray(f)
        b[at] ^= bit
        return bytes(b)

    return {
        "header_checksum": (flip(ind, 14), None),
        "block_checksum": (flip(ind, 30), None),
        "block_checksum_linked": (flip(lnk, 30), None),
        "content_checksum": (flip(ind, len(ind) - 1), None),
        "content_checksum_linked": (flip(lnk, len(lnk) - 1), None),
        "dict_id_mismatch": (dic, DICT[:-1]),
        "dict_required": (dic, None),
        "bad_magic": (b"\x00\x00\x00\x00" + ind[4:], None),
        "version": (flip(ind, 4, 0x80), None),
        "truncated_header": (ind[:9], None),
        "truncated_body": (ind[:len(ind) // 2], None),
        "truncated_linked": (lnk[:len(lnk) // 3], None),
        "no_endmark": (lnk[:-8], None),
        "giant_content_size": (ind[:6] + b"\xff" * 8 + ind[14:], None),
        "truncated_content_checksum": (ind[:-2], None),
    }


CORRUPTIONS = _corruptions()


@pytest.mark.parametrize("verify", [True, False])
@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("kind", list(CORRUPTIONS))
def test_errors_match_jax(kind, backend, verify):
    """Corrupted, truncated and mismatched frames: JAX's error string (or
    JAX's bytes where the frame still decodes), with and without
    verification."""
    frame, d = CORRUPTIONS[kind]
    buf = np.frombuffer(frame, np.uint8)
    want = _error(lambda: lz4.decompress(buf, d, verify, backend=backend))
    got = _error(lambda: pt.decompress(buf, d, verify, backend=backend))
    assert got == want
    if verify and kind != "truncated_body":
        assert want[0] != "ok"


@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("config", ["64k_indep_bck_size", "64k_linked_ck",
                                    "64k_empty_size"])
def test_mutated_frames_match_jax(config, backend):
    """Frames with 1-3 random bytes changed (from a seed): the same
    plaintext or the same error as JAX, frame after frame."""
    rng = np.random.default_rng(0xF022 + len(config))
    data = mixed_payload(0 if "empty" in config else 120_000, 5)
    base = bytes(lz4.compress(data, None, CONFIGS[config]))
    for _ in range(40 if backend == "native" else 12):
        b = bytearray(base)
        for at in rng.integers(0, len(b), int(rng.integers(1, 4))):
            b[int(at)] = int(rng.integers(0, 256))
        buf = np.frombuffer(bytes(b), np.uint8)
        want = _error(lambda: lz4.decompress(buf, backend=backend))
        assert _error(lambda: pt.decompress(buf, backend=backend)) == want


# Hand-built spec vectors, copied from tests/test_golden.py.
def _a_block_hex() -> str:
    return "1F410100" + "FF" * 256 + "E750" + "41" * 5


_PAT = "4142434445464748494A4B4C4D4E4F50"
GOLDEN = {
    "hello": ("04224D186040820B00008048656c6c6f20576f726c6400000000",
              b"Hello World", None),
    "empty_4mb": ("04224D1860707300000000", b"", None),
    "hello_ck": ("04224D186440A70B00008048656c6c6f20576f726c6400000000"
                 "EE16FDB1", b"Hello World", None),
    "multiblock": ("04224D18604082" + ("0B010000" + _a_block_hex()) * 2
                   + "00000000", b"A" * 131072, None),
    "linked_xblock": (
        "04224D184040C0" + "1B010000" + "FF01" + _PAT + "1000" + "FF" * 256
        + "D850" + "4C4D4E4F50" + "8A000000" + "0F1000" + "FF" * 128
        + "6850" + "4C4D4E4F50" + "00000000",
        b"ABCDEFGHIJKLMNOP" * 6144, None),
    "dictionary": ("04224D184140FBE517E7080A0000000F400068506263646566"
                   "00000000", b"0123456789abcdef" * 8,
                   b"0123456789abcdef" * 4),
    "block_ck": ("04224D187040AD0B00008048656C6C6F20576F726C64EE16FDB1"
                 "00000000", b"Hello World", None),
    "mixed_stored": ("04224D18604082" + "0B010000" + _a_block_hex()
                     + "1B000080"
                     + b"incompressible tail bytes!!".hex().upper()
                     + "00000000",
                     b"A" * 65536 + b"incompressible tail bytes!!", None),
    "content_size": ("04224D1868400B00000000000000580B00008048656C6C6F2057"
                     "6F726C6400000000", b"Hello World", None),
}


@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("name", list(GOLDEN))
def test_golden_vectors_decode(name, backend):
    hexs, plain, d = GOLDEN[name]
    frame = np.frombuffer(bytes.fromhex(hexs), np.uint8)
    assert pt.decompress(frame, d, backend=backend).tobytes() == plain


def test_golden_headers_and_frames():
    """The spec's header bytes and the bit-exact Hello World frames."""
    cfg = pt.FrameConfig(block_size=65536, block_independence=True,
                         content_checksum=False, content_size=False)
    f = pt.compress(b"Hello World", config=cfg)
    assert (f[4], f[5], f[6]) == (0x60, 0x40, 0x82)
    assert f.tobytes().hex().upper() == GOLDEN["hello"][0].upper()
    f = pt.compress(b"Hello World", config=cfg.with_(content_checksum=True))
    assert f.tobytes().hex().upper() == GOLDEN["hello_ck"][0].upper()


# -- raw blocks -------------------------------------------------------------

@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("form", ["alloc", "in_place", "window", "table",
                                  "dst_off"])
def test_compress_raw_matches_jax(form, backend):
    """Every argument form of compress_raw: JAX's return value and JAX's
    bytes in the caller's buffer."""
    src = mixed_payload(60_000, 13)
    results = []
    for mod in (lz4, pt):
        if form == "alloc":
            r = mod.compress_raw(src, backend=backend)
            results.append(np.asarray(r).tobytes())
        elif form == "table":
            table = np.zeros(1 << 14, np.int32)
            r = mod.compress_raw(src, hash_table=table, backend=backend)
            results.append((np.asarray(r).tobytes(), table.tobytes()))
        else:
            dst = np.zeros(70_000, np.uint8)
            kw = {"in_place": {}, "window": dict(src_start=1000,
                                                  src_len=40_000),
                  "dst_off": dict(dst_off=123)}[form]
            n = mod.compress_raw(src, dst, backend=backend, **kw)
            results.append((n, dst.tobytes()))
    assert results[0] == results[1]


@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("form", ["capacity", "buffer", "offsets",
                                  "dictionary", "too_small"])
def test_decompress_raw_matches_jax(form, backend):
    src = mixed_payload(60_000, 17)
    if form == "dictionary":
        frame = lz4.compress(src, DICT, FrameConfig(block_size=65536))
        # header 11 B (dictID), the size word; the EndMark
        block = np.asarray(frame)[15:-4]
        args, kw = (len(src),), dict(dictionary=DICT)
    else:
        block = np.asarray(lz4.compress_raw(src))
        args, kw = (len(src),), {}
    results = []
    for mod in (lz4, pt):
        if form == "buffer":
            dst = np.zeros(len(src) + 50, np.uint8)
            results.append(_error(lambda: (mod.decompress_raw(
                block, dst, backend=backend), dst)[1]))
        elif form == "offsets":
            padded = np.concatenate([np.zeros(7, np.uint8), block,
                                     np.zeros(9, np.uint8)])
            dst = np.zeros(len(src) + 64, np.uint8)
            results.append(_error(lambda: (mod.decompress_raw(
                padded, dst, src_off=7, src_len=len(block), dst_off=64 - 1,
                backend=backend), dst)[1][:63 + len(src)]))
        elif form == "too_small":
            results.append(_error(lambda: mod.decompress_raw(
                block, len(src) - 1, backend=backend)))
        else:
            results.append(_error(lambda: mod.decompress_raw(
                block, *args, backend=backend, **kw)))
    assert results[0] == results[1]
    if form == "too_small":
        assert results[1] == ("ValueError", "LZ4: Output Buffer Too Small")
    else:
        assert results[1][0] == "ok"


# -- strings and objects ----------------------------------------------------

TYPED = {
    "ascii": "hello world " * 500,
    "emoji": "héllo wörld 🚀🔥 " * 300,
    "object": {"a": [1, 2, 3], "b": {"c": "d" * 2000}, "e": None},
    "array": [{"id": i, "ok": i % 2 == 0} for i in range(300)],
}


@pytest.mark.parametrize("name", list(TYPED))
def test_type_helpers_match_jax(name):
    value = TYPED[name]
    cfg = FrameConfig(block_size=65536, content_checksum=True)
    if isinstance(value, str):
        want = lz4.compress_string(value, config=cfg)
        got = pt.compress_string(value, config=cfg)
        back = pt.decompress_string(want)
    else:
        want = lz4.compress_object(value, config=cfg)
        got = pt.compress_object(value, config=cfg)
        back = pt.decompress_object(want)
    assert got.tobytes() == np.asarray(want).tobytes()
    assert back == value
    with_dict = pt.compress_string(str(value), DICT, backend="python")
    assert pt.decompress_string(with_dict, DICT) == \
        lz4.decompress_string(with_dict, DICT) == str(value)


def test_unserializable_object_raises_as_jax():
    errors = []
    for mod in (lz4, pt):
        with pytest.raises(ValueError) as e:
            mod.compress_object({"x": object()})
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert errors[1].startswith("LZ4: Input cannot be serialized to JSON")


# -- scheduler, async, worker -----------------------------------------------

def test_scheduler_fifo_limits_concurrency():
    order = []

    async def run():
        sched = pt.Scheduler(2)
        running = peak = 0

        async def task(i):
            nonlocal running, peak
            running += 1
            peak = max(peak, running)
            await asyncio.sleep(0.001)
            order.append(i)
            running -= 1
            return i

        results = await asyncio.gather(
            *[sched.schedule(lambda i=i: task(i)) for i in range(6)])
        return results, peak

    results, peak = asyncio.run(run())
    assert results == list(range(6))
    assert peak == 2
    assert sorted(order[:2]) == [0, 1] and order[2:] != []


def test_scheduler_rejects_bad_concurrency():
    errors = []
    for mod in (lz4, pt):
        with pytest.raises(ValueError) as e:
            mod.Scheduler(0)
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "LZ4: Scheduler concurrency must be >= 1"


ASYNC_CFG = {
    "indep_ck": FrameConfig(block_size=65536, block_independence=True,
                            content_checksum=True),
    "linked": FrameConfig(block_size=65536),
}


@pytest.mark.parametrize("chunk", [1 << 22, 70_000])
@pytest.mark.parametrize("config", list(ASYNC_CFG))
def test_async_oneshot_matches_jax(config, chunk, one_torch_thread):  # noqa: F811
    """compress_async / decompress_async on device="cpu" with the port's
    default backend="device": JAX's backend="device" frame and JAX's
    plaintext; backend="native" gives JAX's host frame."""
    cfg = ASYNC_CFG[config]
    data = mixed_payload(330_000, 19)

    async def run(mod, backend, **kw):
        frame = await mod.compress_async(data, config=cfg, chunk_size=chunk,
                                         backend=backend, **kw)
        out = await mod.decompress_async(frame, chunk_size=chunk // 3,
                                         backend=backend, **kw)
        return frame, out

    want = asyncio.run(run(jaio, "device"))
    got = asyncio.run(run(pt, "device", device="cpu"))
    assert got == want
    assert got[1] == data.tobytes()
    host = asyncio.run(run(pt, "native", device="cpu"))
    assert host[0] == asyncio.run(run(jaio, None))[0]
    assert host[1] == data.tobytes()


def test_async_streams_match_jax(one_torch_thread):  # noqa: F811
    data = mixed_payload(300_000, 23)
    cfg = ASYNC_CFG["indep_ck"]
    chunks = [data[i: i + 140_000] for i in range(0, len(data), 140_000)]

    async def run(mod, **kw):
        cs = mod.create_async_compress_stream(cfg, backend="device", **kw)
        comp = b""
        async for part in cs.pipe(chunks):
            comp += part
        ds = mod.create_async_decompress_stream(backend="device", **kw)
        out = b""
        async for part in ds.pipe([comp[i: i + 9000]
                                   for i in range(0, len(comp), 9000)]):
            out += part
        return comp, out

    want = asyncio.run(run(jaio))
    got = asyncio.run(run(pt, device="cpu"))
    assert got == want
    assert got[1] == data.tobytes()


def test_async_stream_device_defaults_to_cuda():
    """backend defaults to "device" and device to "cuda": without a GPU
    building the stream raises, never carries on on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for make in (pt.AsyncCompressStream, pt.AsyncDecompressStream):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            make()
    assert pt.AsyncCompressStream(backend="native") is not None


def test_worker_buffer_tasks_match_jax():
    data = mixed_payload(200_000, 29)
    cfg = FrameConfig(block_size=65536, content_checksum=True)
    want = JaxWorker.compress(data, config=cfg).result()
    got = pt.LZ4Worker.compress(data, config=cfg).result()
    assert got.tobytes() == np.asarray(want).tobytes()
    out = pt.LZ4Worker.decompress(np.array(got)).result()
    assert out.tobytes() == data.tobytes()
    frames = list(pt.LZ4Worker.map_compress([data[:50_000], data[50_000:]],
                                            config=cfg))
    assert [f.tobytes() for f in frames] == [
        np.asarray(lz4.compress(x, None, cfg)).tobytes()
        for x in (data[:50_000], data[50_000:])]


def test_worker_streams_match_jax(one_torch_thread):  # noqa: F811
    data = mixed_payload(300_000, 31)
    cfg = ASYNC_CFG["indep_ck"]
    chunks = [data[i: i + 280_000] for i in range(0, len(data), 280_000)]
    want = JaxWorker.compress_stream(chunks, config=cfg,
                                     backend="device").result()
    got = pt.LZ4Worker.compress_stream(chunks, config=cfg,
                                       device="cpu").result()
    assert got == want
    parts = [got[i: i + 9000] for i in range(0, len(got), 9000)]
    assert pt.LZ4Worker.decompress_stream(parts, device="cpu").result() \
        == data.tobytes()


def test_worker_error_propagates():
    fut = pt.LZ4Worker.decompress(b"\x00\x00\x00\x00not-a-frame")
    with pytest.raises(ValueError, match="LZ4: Invalid Magic Number"):
        fut.result()


def test_worker_process_pool_roundtrip():
    """Buffer tasks in a spawn process pool."""
    data = np.frombuffer(b"process pool payload " * 3000, np.uint8)
    try:
        pt.LZ4Worker.configure(max_workers=2, use_processes=True)
        futs = [pt.LZ4Worker.compress(data) for _ in range(2)]
        frames = [f.result(timeout=120) for f in futs]
        want = np.asarray(lz4.compress(data)).tobytes()
        for fr in frames:
            assert fr.tobytes() == want
            assert pt.LZ4Worker.decompress(np.array(fr)).result(
                timeout=120).tobytes() == data.tobytes()
        ctx = pt.LZ4Worker._pool._mp_context
        assert ctx.get_start_method() == "spawn"
    finally:
        pt.LZ4Worker.configure(max_workers=4, use_processes=False)


# -- the facade -------------------------------------------------------------

JAX_LAZY = ["LZ4Encoder", "LZ4Decoder", "create_compress_stream",
            "create_decompress_stream", "CompressStream", "DecompressStream",
            "compress_file", "decompress_file", "compress_async",
            "decompress_async", "create_async_compress_stream",
            "create_async_decompress_stream", "Scheduler", "LZ4Worker",
            "parallel", "compress_frames", "decompress_frames"]


@pytest.mark.parametrize("name", sorted(set(lz4.__all__) | set(JAX_LAZY)))
def test_every_jax_facade_name_resolves(name):
    assert getattr(pt, name) is not None
    assert name in pt.__all__


def test_host_and_device_names():
    """compress / decompress are the host codec (JAX's compress); the
    top-level compress_frame stays the device codec (device=)."""
    from divortio_lz4_tpu_torch import frame
    from divortio_lz4_tpu_torch.parallel import device
    assert pt.compress is frame.compress_frame
    assert pt.decompress is frame.decompress_frame
    assert pt.compress_frame is device.compress_frame
    assert pt.decompress_frame is device.decompress_frame
    assert pt.NATIVE_AVAILABLE is True
    assert pt.available_backends() == lz4.available_backends()
    assert pt.utils.concat_bytes([b"ab", np.frombuffer(b"cd", np.uint8),
                                  bytearray(b"e")]) == b"abcde"
    for n in (0, 1, 65536, 10 ** 7):
        for bs in (65536, 4 << 20):
            assert pt.constants.frame_bound(n, bs) == \
                lz4.constants.frame_bound(n, bs)


def test_import_builds_nothing():
    """import divortio_lz4_tpu_torch (and its facade names) builds and
    loads no library; NATIVE_AVAILABLE does, at its first access."""
    code = "\n".join([
        "import ctypes, subprocess",
        "calls = []",
        "real_cdll, real_run = ctypes.CDLL, subprocess.run",
        "ctypes.CDLL = lambda *a, **k: (calls.append(a[0]),"
        " real_cdll(*a, **k))[1]",
        "subprocess.run = lambda *a, **k: (calls.append(a[0]),"
        " real_run(*a, **k))[1]",
        "import divortio_lz4_tpu_torch as pt",
        "names = [pt.compress, pt.decompress, pt.compress_raw, pt.LZ4Worker,",
        "         pt.compress_async, pt.Scheduler, pt.parallel.MultiHostCodec]",
        "assert not [c for c in calls if 'lz4' in str(c)], calls",
        "assert 'NATIVE_AVAILABLE' not in vars(pt)",
        "assert pt.NATIVE_AVAILABLE is True",
        "assert [c for c in calls if 'host_kernels' in str(c)], calls",
    ])
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=300)
