"""The port's streams (divortio_lz4_tpu_torch.stream) held against the JAX
package's on the CPU.

The same numpy-made inputs go through JAX's LZ4Encoder / LZ4Decoder (its
device bursts on the CPU: the XLA chain builder, the Pallas split kernels
in interpret mode) and the port's, with backend="device" (device="cpu":
the chain builder's torch ops and the kernels' plain versions) and with
the host backends "native" and "python". Frame bytes and decoded chunks
must be equal, byte for byte (tolerance 0), whatever the feed: whole,
fragments that cut blocks, byte at a time, resumed from a checkpoint. The
JAX decoder buckets its bursts at 64 blocks and powers of two and the
port does not, so ``stats`` are compared exactly only where each JAX
burst takes every buffered block; elsewhere the port serves at least as
many blocks on the device. Then the cases of tests/test_stream.py,
tests/test_checkpoint.py and tests/test_split_encode.py's streaming tests
run through the port.
"""

import pickle

import numpy as np
import pytest
import torch

import divortio_lz4_tpu as lz4
import divortio_lz4_tpu.stream as js
import divortio_lz4_tpu_torch as pt
import divortio_lz4_tpu_torch.stream as ps
from _torch_port import cuda, mixed_payload  # noqa: F401  (cuda: fixture)
from _torch_port import one_torch_thread  # noqa: F401  (fixture)
from conftest import make_compressible
from divortio_lz4_tpu.config import FrameConfig
from divortio_lz4_tpu.ops.pallas_split_decode import (
    decode_wire_blocks2 as jax_decode_wire_blocks2)
from divortio_lz4_tpu.parallel.device import parse_block_index
from divortio_lz4_tpu_torch.ops.stream_decode import decode_wire_blocks2
from test_fuzz import _assert_taxonomy

CFG = FrameConfig(block_size=65536, block_independence=True)
CONFIGS = {
    "indep_content_ck": CFG.with_(content_checksum=True),
    "linked_content_ck": CFG.with_(block_independence=False,
                                   content_checksum=True),
    "indep_block_ck": CFG.with_(block_checksums=True),
    "linked_block_ck": CFG.with_(block_independence=False,
                                 block_checksums=True),
    "indep_256k": CFG.with_(block_size=262144, content_checksum=True),
    "default_4m_linked": FrameConfig(content_checksum=True),
}
FEEDS = {"whole": None, "100k": 100_000, "150k": 150_000, "odd": 7919}


def collect(chunks):
    return b"".join(bytes(c) for c in chunks)


def _corpus(n=400_000, tail=70_000, seed=0xD1507):
    rng = np.random.default_rng(seed)
    return np.concatenate([make_compressible(n),
                           rng.integers(0, 256, tail, dtype=np.uint8)])


def _parts(data, feed):
    if feed is None:
        return [data]
    return [data[i: i + feed] for i in range(0, len(data), feed)]


def _kw(mod, backend, device="cpu"):
    return {"device": device} if mod is ps and backend == "device" else {}


def _encode(mod, cfg, data, feed, backend, dictionary=None, device="cpu"):
    enc = mod.LZ4Encoder(cfg, dictionary, backend, **_kw(mod, backend,
                                                         device))
    out = []
    for part in _parts(data, feed):
        out += enc.add(part)
    out += enc.finish()
    return b"".join(bytes(c) for c in out), enc.stats


def _decode(mod, frame, feed, backend, dictionary=None, verify=True,
            device="cpu"):
    dec = mod.LZ4Decoder(dictionary, verify, backend, **_kw(mod, backend,
                                                            device))
    chunks = []
    for part in _parts(frame, feed):
        chunks += [bytes(c) for c in dec.update(part)]
    return chunks, dec.stats, dec.finished_frame


def _stats(stats):
    return stats["host_blocks"], stats["device_blocks"]


# -- encoder ----------------------------------------------------------------

@pytest.mark.parametrize("feed", list(FEEDS))
@pytest.mark.parametrize("config", list(CONFIGS))
def test_device_encoder_matches_jax(config, feed, one_torch_thread):  # noqa: F811
    """backend="device": the same frame bytes and the same stats as JAX's
    device bursts (the port's burst cap does not bind at this size), and
    the frame decodes to the corpus."""
    cfg = CONFIGS[config]
    data = _corpus()
    want, want_stats = _encode(js, cfg, data, FEEDS[feed], "device")
    got, got_stats = _encode(ps, cfg, data, FEEDS[feed], "device")
    assert got == want
    assert _stats(got_stats) == _stats(want_stats)
    if cfg.resolved_block_size == 65536 and feed == "whole":
        assert got_stats["device_blocks"] > 0
    assert np.asarray(lz4.decompress(np.frombuffer(got, np.uint8))) \
        .tobytes() == data.tobytes()


@pytest.mark.parametrize("feed", ["whole", "odd"])
@pytest.mark.parametrize("config", ["indep_content_ck", "linked_content_ck",
                                    "linked_block_ck"])
def test_host_encoder_matches_jax(config, feed):
    """backend="native": JAX's host codec bytes, every block on the
    host."""
    cfg = CONFIGS[config]
    data = _corpus()
    want, want_stats = _encode(js, cfg, data, FEEDS[feed], "native")
    got, got_stats = _encode(ps, cfg, data, FEEDS[feed], "native")
    assert got == want
    assert _stats(got_stats) == _stats(want_stats)
    assert got_stats["device_blocks"] == 0


@pytest.mark.parametrize("config", ["indep_content_ck", "linked_content_ck"])
def test_python_backend_encoder_matches_jax(config):
    cfg = CONFIGS[config]
    data = _corpus(60_000, 10_000)
    want = _encode(js, cfg, data, 7919, "python")[0]
    assert _encode(ps, cfg, data, 7919, "python")[0] == want
    assert _encode(ps, cfg, data, 7919, "native")[0] == want


def test_device_encoder_with_dictionary_matches_jax(one_torch_thread):  # noqa: F811
    """A dictionary sends every block to the host codec, as in JAX."""
    data = _corpus()
    d = np.array(data[:8000])
    for name in ("indep_content_ck", "linked_content_ck"):
        want, ws = _encode(js, CONFIGS[name], data, None, "device", d)
        got, gs = _encode(ps, CONFIGS[name], data, None, "device", d)
        assert got == want and _stats(gs) == _stats(ws)
        assert gs["device_blocks"] == 0


def test_linked_bursts_interleave_with_host_blocks(one_torch_thread):  # noqa: F811
    """tests/test_split_encode.py:278-300: fragments whose carried
    remainder goes to the host between bursts, and a burst resumed from a
    checkpoint in mid-stream (the snapshot taken by either package): the
    carried window and the frame are JAX's."""
    cfg = CONFIGS["linked_content_ck"]
    data = _corpus(380_000, 30_000)
    feeds = [70_000, 330_000, 10_000]
    for first_mod in (js, ps):
        encs = {mod: mod.LZ4Encoder(cfg, None, "device", **_kw(mod,
                                                               "device"))
                for mod in (js, ps)}
        outs = {mod: [] for mod in encs}
        at = 0
        for i, n in enumerate(feeds):
            for mod, enc in encs.items():
                outs[mod] += enc.add(data[at: at + n])
            at += n
            assert encs[ps].state_dict() == encs[js].state_dict()
            if i == 0:
                snap = pickle.loads(pickle.dumps(
                    encs[first_mod].state_dict()))
                encs[ps] = ps.LZ4Encoder.from_state(snap, "device",
                                                    device="cpu")
        for mod, enc in encs.items():
            outs[mod] += enc.finish()
        assert collect(outs[ps]) == collect(outs[js])
        assert encs[ps].stats["device_blocks"] >= 4
    out = np.asarray(lz4.decompress(np.frombuffer(collect(outs[ps]),
                                                  np.uint8)))
    assert out.tobytes() == data.tobytes()


# -- decoder ----------------------------------------------------------------

def _frames():
    data = _corpus()
    d = np.array(data[:8000])
    wide = np.concatenate([make_compressible(5 * 262144),
                           np.random.default_rng(5).integers(
                               0, 256, 100_000, dtype=np.uint8)])

    def frame(x, cfg, dictionary=None):
        return np.asarray(lz4.compress(x, config=cfg,
                                       dictionary=dictionary)).tobytes()
    a = frame(data[:200_000], CONFIGS["indep_content_ck"])
    b = frame(data[200_000:], CONFIGS["linked_content_ck"])
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") \
        + b"\x00" * 5
    return {
        "indep_content_ck": (frame(data, CONFIGS["indep_content_ck"]), None),
        "indep_block_ck": (frame(data, CONFIGS["indep_block_ck"]), None),
        "indep_256k": (frame(wide, CONFIGS["indep_256k"]), None),
        "linked": (frame(data, CONFIGS["linked_content_ck"]), None),
        "dictionary": (frame(data, CONFIGS["indep_content_ck"], d), d),
        "concat_skippable": (a + skip + b + a, None),
    }


FRAMES = _frames()


@pytest.mark.parametrize("feed", ["whole", "150k", "odd"])
@pytest.mark.parametrize("frame", list(FRAMES))
def test_device_decoder_matches_jax(frame, feed, one_torch_thread):  # noqa: F811
    """backend="device": the same decoded chunks as JAX's device decoder;
    the port serves at least JAX's device blocks."""
    buf, d = FRAMES[frame]
    want, ws, wf = _decode(js, buf, FEEDS[feed], "device", d)
    got, gs, gf = _decode(ps, buf, FEEDS[feed], "device", d)
    assert got == want
    assert gf and wf
    assert sum(_stats(gs)) == sum(_stats(ws)) == len(got)
    assert gs["device_blocks"] >= ws["device_blocks"]
    if frame in ("indep_content_ck", "indep_256k") and feed == "whole":
        assert gs["host_blocks"] == 0 and gs["device_bursts"] == 1


@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("frame", ["indep_block_ck", "linked", "dictionary",
                                   "concat_skippable"])
def test_host_decoder_matches_jax(frame, backend):
    buf, d = FRAMES[frame]
    want, ws, _ = _decode(js, buf, 7919, backend, d)
    got, gs, _ = _decode(ps, buf, 7919, backend, d)
    assert got == want and _stats(gs) == _stats(ws)


def test_decoder_stats_match_where_jax_buckets_do_not_bind(one_torch_thread):  # noqa: F811
    """Eight full blocks in one feed: JAX takes all eight in one burst (a
    power of two, under 64), and so does the port."""
    x = make_compressible(8 * 65536)
    buf = np.asarray(lz4.compress(x, config=CONFIGS["indep_content_ck"])) \
        .tobytes()
    want, ws, _ = _decode(js, buf, None, "device")
    got, gs, _ = _decode(ps, buf, None, "device")
    assert got == want
    assert _stats(gs) == _stats(ws) == (0, 8)
    # a 99-block feed: JAX 64 + 32 on the device and 3 on the host, the
    # port one burst of 99
    x = make_compressible(99 * 65536)
    buf = np.asarray(lz4.compress(x, config=CONFIGS["indep_content_ck"])) \
        .tobytes()
    want, ws, _ = _decode(js, buf, None, "device")
    got, gs, _ = _decode(ps, buf, None, "device")
    assert got == want
    assert _stats(ws) == (3, 96) and _stats(gs) == (0, 99)
    assert gs["device_bursts"] == 1


def test_decoder_byte_at_a_time_and_resume(one_torch_thread):  # noqa: F811
    """A frame of five blocks fed a byte at a time (every block completes
    alone, so the host codec serves it, as in JAX), and a device decoder
    resumed in mid-frame from a snapshot of either package, beside JAX's
    resumed from the same snapshot. The snapshot does not carry the
    frame's block size, so both finish that frame on the host codec
    (a reference quirk, kept)."""
    x = make_compressible(5 * 65536 + 1234)
    buf = np.asarray(lz4.compress(x, config=CONFIGS["indep_content_ck"])) \
        .tobytes()
    want, ws, _ = _decode(js, buf, 1, "device")
    got, gs, gf = _decode(ps, buf, 1, "device")
    assert got == want and _stats(gs) == _stats(ws) and gf
    assert b"".join(got) == x.tobytes()
    frame, _ = FRAMES["indep_content_ck"]
    frame2 = frame + frame      # the second frame starts afresh: a burst
    cut = 300
    for snap_mod in (js, ps):
        dec = snap_mod.LZ4Decoder(None, True, "device",
                                  **_kw(snap_mod, "device"))
        part1 = collect(dec.update(frame2[:cut]))
        snap = pickle.loads(pickle.dumps(dec.state_dict()))
        resumed = {mod: mod.LZ4Decoder.from_state(snap, "device",
                                                  **_kw(mod, "device"))
                   for mod in (js, ps)}
        parts = {mod: [bytes(c) for c in d.update(frame2[cut:])]
                 for mod, d in resumed.items()}
        assert parts[ps] == parts[js]
        assert part1 + b"".join(parts[ps]) == _corpus().tobytes() * 2
        assert _stats(resumed[ps].stats) == _stats(resumed[js].stats)
        assert resumed[ps].finished_frame
        assert resumed[ps].stats["device_blocks"] == 8


def test_device_decoder_mutation_fuzz(one_torch_thread):  # noqa: F811
    """tests/test_fuzz.py:284-305 through the port: mutated frames are
    rejected with JAX's error taxonomy or decode to at most their bound,
    never a fault; where neither package raises, the chunks are JAX's."""
    rng = np.random.default_rng(0xD1507)
    data = make_compressible(400_000)
    base = np.asarray(lz4.compress(
        data, config=CONFIGS["indep_content_ck"])).tobytes()
    for _ in range(12):
        buf = bytearray(base)
        buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
        outcomes = []
        for mod in (js, ps):
            try:
                got = _decode(mod, bytes(buf), None, "device")[0]
                assert sum(map(len, got)) <= len(data) + 65536
                outcomes.append(got)
            except (ValueError, IndexError) as e:
                _assert_taxonomy(e)
                outcomes.append(None)
        if None not in outcomes:
            assert outcomes[0] == outcomes[1]


def test_decoder_errors_match_jax():
    """The FSM's errors, on every backend, are JAX's."""
    data = make_compressible(5000)
    d = np.frombuffer(b"dictionary-content-shared", np.uint8)
    dframe = np.asarray(lz4.compress(data, dictionary=d)).tobytes()
    ck = bytearray(np.asarray(lz4.compress(
        data, config=FrameConfig(content_checksum=True))).tobytes())
    ck[-1] ^= 0xAA
    cases = [(b"\x00\x00\x00\x00", None, "Invalid Magic Number"),
             (dframe, None, "requires a Dictionary"),
             (dframe, np.frombuffer(b"some-other-dictionary!!!!", np.uint8),
              "Dictionary ID Mismatch"),
             (bytes(ck), None, "Content Checksum")]
    for backend in ("device", "native", "python"):
        for buf, dic, msg in cases:
            for mod in (js, ps):
                with pytest.raises(ValueError, match=msg):
                    _decode(mod, buf, None, backend, dic)


# -- the burst decode ---------------------------------------------------------

def _blocks(frame_bytes):
    f = np.frombuffer(frame_bytes, np.uint8)
    return [f[o: o + s] for o, s, st in parse_block_index(f)[1] if not st]


@pytest.mark.parametrize("frame", ["indep_content_ck", "indep_256k"])
def test_decode_wire_blocks2_matches_jax(frame, one_torch_thread):  # noqa: F811
    """64 KB blocks (the compact route) and 256 KB blocks (the wire
    route) against JAX's decode_wire_blocks2."""
    comps = _blocks(FRAMES[frame][0])
    bs = 262144 if frame == "indep_256k" else 65536
    want = jax_decode_wire_blocks2(comps, bs)
    got = decode_wire_blocks2(comps, bs, device="cpu")
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.tobytes() == np.asarray(w).tobytes()
    assert decode_wire_blocks2([], bs, device="cpu") == []


def test_decode_wire_blocks2_errors_match_jax():
    comps = _blocks(FRAMES["indep_content_ck"][0])[:3]
    bad = comps[:1] + [np.array([0x14, 0x41, 0x00, 0x00], np.uint8)]
    with pytest.raises(ValueError, match="LZ4: Invalid Offset 0"):
        jax_decode_wire_blocks2(bad, 65536)
    with pytest.raises(ValueError, match="LZ4: Invalid Offset 0"):
        decode_wire_blocks2(bad, 65536, device="cpu")


# -- defaults and devices -----------------------------------------------------

def test_stream_defaults_to_the_card():
    """backend="device" and device="cuda" are the defaults: without a GPU
    the device streams raise when built; the host backends need no
    device."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error cannot show")
    for build in (lambda: ps.LZ4Encoder(CFG), lambda: ps.LZ4Decoder(),
                  lambda: pt.create_compress_stream(),
                  lambda: pt.create_decompress_stream(),
                  lambda: ps.LZ4Encoder.from_state(
                      ps.LZ4Encoder(CFG, backend="native").state_dict())):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            build()
    frame = collect(ps.CompressStream(CFG, backend="native").pipe([b"x"]))
    assert pt.DecompressStream(backend="python").write(frame) == b"x"
    with pytest.raises(KeyError, match="LZ4: unknown backend"):
        ps.LZ4Encoder(CFG, backend="gpu")


@pytest.mark.cuda
def test_cuda_stream_bursts_match_cpu(cuda, one_torch_thread):  # noqa: F811
    """On the card: the encoder's bursts give the CPU's frame bytes, and
    the decoder's bursts (compact and wire kernels) give the CPU's
    chunks, launching the kernels."""
    from divortio_lz4_tpu_torch.ops.compact_decode import \
        decode_blocks_compact
    from divortio_lz4_tpu_torch.ops.wire_decode import decode_blocks_wire
    data = _corpus()
    for name in ("indep_content_ck", "linked_content_ck"):
        cpu = _encode(ps, CONFIGS[name], data, 150_000, "device")
        card = _encode(ps, CONFIGS[name], data, 150_000, "device",
                       device="cuda")
        assert card[0] == cpu[0] and card[1] == cpu[1]
    for name, fn in (("indep_content_ck", decode_blocks_compact),
                     ("indep_256k", decode_blocks_wire)):
        fn.launches = 0
        cpu = _decode(ps, FRAMES[name][0], None, "device")
        card = _decode(ps, FRAMES[name][0], None, "device", device="cuda")
        assert card[0] == cpu[0] and card[1] == cpu[1]
        assert fn.launches == 1


# -- the cases of tests/test_stream.py, test_checkpoint.py and
# test_split_encode.py:213-300, through the port (backend="device" on the
# CPU unless the case names a host backend) ---------------------------------

def _enc(cfg=pt.DEFAULT_CONFIG, dictionary=None, backend="device"):
    return ps.LZ4Encoder(cfg, dictionary, backend,
                         **({"device": "cpu"} if backend == "device" else {}))


def _dec(dictionary=None, verify=True, backend="device"):
    return ps.LZ4Decoder(dictionary, verify, backend,
                         **({"device": "cpu"} if backend == "device" else {}))


def test_encoder_emits_header_and_endmark():
    enc = _enc()
    out = enc.add(b"hi")
    assert out and bytes(out[0][:4]) == bytes([0x04, 0x22, 0x4D, 0x18])
    assert bytes(enc.finish()[-1][-4:]) == b"\x00\x00\x00\x00"
    with pytest.raises(RuntimeError, match="closed"):
        enc.add(b"more")
    with pytest.raises(RuntimeError, match="closed"):
        enc.finish()


def test_encoder_buffers_until_block_size():
    enc = _enc(pt.FrameConfig(block_size=65536))
    assert len(enc.add(make_compressible(1000))) == 1   # header only
    assert len(enc.add(make_compressible(70_000))) >= 1


@pytest.mark.parametrize("direction", ["stream_to_frame", "frame_to_stream"])
def test_stream_and_one_shot_paths_interoperate(direction):
    data = make_compressible(200_000)
    cfg = pt.FrameConfig(block_size=65536)
    if direction == "stream_to_frame":
        enc = _enc(cfg)
        frame = b""
        for i in range(0, len(data), 7919):
            frame += collect(enc.add(data[i: i + 7919]))
        frame += collect(enc.finish())
        out = pt.decompress_frame(frame, device="cpu")
        assert out.tobytes() == data.tobytes()
        assert np.asarray(lz4.decompress(np.frombuffer(frame, np.uint8))) \
            .tobytes() == data.tobytes()
    else:
        frame = pt.compress_frame(data, cfg, device="cpu").tobytes()
        dec = _dec()
        out = b""
        for i in range(0, len(frame), 50):
            out += collect(dec.update(frame[i: i + 50]))
        assert out == data.tobytes() and dec.finished_frame


def test_decoder_byte_at_a_time_and_concatenated():
    data = make_compressible(5000)
    frame = np.asarray(lz4.compress(data)).tobytes()
    dec = _dec()
    out = b"".join(collect(dec.update(frame[i: i + 1]))
                   for i in range(len(frame)))
    assert out == data.tobytes()
    a, b = make_compressible(3000), make_compressible(2000)[::-1].copy()
    both = pt.compress_frame(a, device="cpu").tobytes() \
        + pt.compress_frame(b, device="cpu").tobytes()
    dec = _dec()
    assert collect(dec.update(both)) == a.tobytes() + b.tobytes()
    assert dec.finished_frame


def test_decoder_content_checksum_corruption():
    data = make_compressible(5000)
    frame = bytearray(pt.compress_frame(
        data, pt.FrameConfig(content_checksum=True), device="cpu"))
    frame[-1] ^= 0xAA
    with pytest.raises(ValueError, match="Content Checksum"):
        _dec().update(bytes(frame))
    assert collect(_dec(verify=False).update(bytes(frame))) == data.tobytes()


def test_stream_roundtrip_with_dictionary():
    data = make_compressible(150_000)
    d = np.array(data[:4000])
    enc = _enc(pt.FrameConfig(block_size=65536), d)
    frame = collect(enc.add(data)) + collect(enc.finish())
    assert collect(_dec(d).update(frame)) == data.tobytes()
    assert np.asarray(lz4.decompress(np.frombuffer(frame, np.uint8),
                                     dictionary=d)).tobytes() \
        == data.tobytes()


def test_sliding_window_across_chunk_boundaries(one_torch_thread):  # noqa: F811
    data = make_compressible(300_000)
    enc_l = _enc(pt.FrameConfig(block_size=65536, block_independence=False))
    enc_i = _enc(pt.FrameConfig(block_size=65536, block_independence=True))
    frame_l = collect(enc_l.add(data)) + collect(enc_l.finish())
    frame_i = collect(enc_i.add(data)) + collect(enc_i.finish())
    assert len(frame_l) <= len(frame_i)
    assert enc_l.stats["device_blocks"] == enc_i.stats["device_blocks"] == 4
    assert collect(_dec().update(frame_l)) == data.tobytes()


def test_stream_block_checksums(one_torch_thread):  # noqa: F811
    data = make_compressible(300_000)
    cfg = pt.FrameConfig(block_size=65536, block_independence=True,
                         block_checksums=True)
    enc = _enc(cfg)
    frame = bytearray(collect(enc.add(data)) + collect(enc.finish()))
    dec = _dec()
    assert collect(dec.update(bytes(frame))) == data.tobytes()
    assert dec.stats["device_blocks"] == 5
    frame[30] ^= 0xFF
    with pytest.raises(ValueError, match="Checksum"):
        _dec().update(bytes(frame))


def test_transform_stream_pipe():
    data = make_compressible(123_456).tobytes()
    chunks = [data[i: i + 10_000] for i in range(0, len(data), 10_000)]
    comp = b"".join(pt.create_compress_stream(
        pt.FrameConfig(block_size=65536), device="cpu").pipe(chunks))
    out = b"".join(pt.create_decompress_stream(device="cpu").pipe(
        [comp[i: i + 8192] for i in range(0, len(comp), 8192)]))
    assert out == data
    assert pt.DecompressStream(device="cpu").flush() == b""


@pytest.mark.parametrize("backend", ["device", "native"])
def test_file_roundtrip_matches_jax(tmp_path, backend, one_torch_thread):  # noqa: F811
    """compress_file / decompress_file, 64 KB chunks: the port's file is
    JAX's with the same backend, and decodes back."""
    data = _corpus().tobytes()
    src, back = tmp_path / "input.bin", tmp_path / "restored.bin"
    src.write_bytes(data)
    kw = {"device": "cpu"} if backend == "device" else {}
    cfg = pt.FrameConfig(block_size=65536, block_independence=True)
    csize = pt.compress_file(str(src), str(tmp_path / "port.lz4"), cfg,
                             chunk_size=300_000, backend=backend, **kw)
    js.compress_file(str(src), str(tmp_path / "jax.lz4"), CFG,
                     chunk_size=300_000, backend=backend)
    port_bytes = (tmp_path / "port.lz4").read_bytes()
    assert len(port_bytes) == csize
    assert port_bytes == (tmp_path / "jax.lz4").read_bytes()
    psize = pt.decompress_file(str(tmp_path / "port.lz4"), str(back),
                               chunk_size=70_000, backend=backend, **kw)
    assert psize == len(data) and back.read_bytes() == data


@pytest.mark.parametrize("independent", [True, False])
def test_encoder_checkpoint_mid_stream(independent, one_torch_thread):  # noqa: F811
    """Resumed after the first feed, the encoder emits what an
    uninterrupted one fed the same chunks emits (the second feed is a
    burst of 6 blocks on the device)."""
    data = make_compressible(600_000).tobytes()
    cfg = pt.FrameConfig(block_size=65536, content_checksum=True,
                         block_independence=independent)
    ref = _enc(cfg)
    frame_ref = collect(ref.add(data[:150_000])) \
        + collect(ref.add(data[150_000:])) + collect(ref.finish())
    assert ref.stats["device_blocks"] == 6
    enc = _enc(cfg)
    out1 = collect(enc.add(data[:150_000]))
    enc2 = ps.LZ4Encoder.from_state(pickle.loads(pickle.dumps(
        enc.state_dict())), device="cpu")
    out2 = collect(enc2.add(data[150_000:])) + collect(enc2.finish())
    assert out1 + out2 == frame_ref
    assert pt.decompress_frame(out1 + out2, device="cpu").tobytes() == data


def test_decoder_checkpoint_preserves_dictionary():
    data = make_compressible(120_000)
    d = np.array(data[:5000])
    frame = np.asarray(lz4.compress(data, dictionary=d, config=FrameConfig(
        block_size=65536))).tobytes()
    dec = _dec(d)
    part1 = collect(dec.update(frame[:100]))
    dec2 = ps.LZ4Decoder.from_state(dec.state_dict(), device="cpu")
    assert part1 + collect(dec2.update(frame[100:])) == data.tobytes()


def test_streaming_backend_observability(one_torch_thread):  # noqa: F811
    """tests/test_split_encode.py:244-266 through the port."""
    corpus = make_compressible(400_000)
    cfg = pt.FrameConfig(block_size=65536, block_independence=True)
    enc = _enc(cfg)
    frame = collect(enc.add(corpus)) + collect(enc.finish())
    assert enc.stats["device_blocks"] == 6 and enc.stats["host_blocks"] == 1
    host = _enc(cfg, backend="native")
    host.add(corpus)
    host.finish()
    assert host.stats["device_blocks"] == 0
    assert host.stats["host_blocks"] == 7
    dec = _dec()
    assert collect(dec.update(frame)) == corpus.tobytes()
    assert dec.stats["device_blocks"] == 7 and dec.stats["host_blocks"] == 0
