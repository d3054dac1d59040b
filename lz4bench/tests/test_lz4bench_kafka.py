"""Kafka's LZ4 record batches (``kafka-lz4``: one frame a batch, 64 KB
independent blocks, no checksums, no content size) in the harness: its
frames under the plain reference and Kafka's header bytes, its controls
and planted faults against ``correct``, the five readers of the
small-frame path on a hand-built trace and on a profile recorded on the
CPU, and its cell traced on the card.

A CPU run keeps the batches at their 16 KB and cuts the cell's deck of
1024 to its first 8, from a 16 MiB corpus: every frame builds a whole 64
KB row, which the chain builder's torch ops take ~0.2 s for on one CPU
thread."""

import os
import types

import numpy as np
import pytest

from lz4bench import checks, run, traffic
from lz4bench.corpus import make_corpus
from lz4bench.metrics import _trace
from lz4bench.reference.frame import decode_frame, read_frame
from lz4bench.reference.xxh32 import xxh32
from lz4bench.tests.test_lz4bench_control import _Broken, _codec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELL = "kafka-lz4.batch16k"
BATCH = 16384
COMPRESS = ["row_pad_per_byte.compress", "host_us_per_frame.compress",
            "device_wait_us_per_frame.compress"]
DECOMPRESS = ["host_us_per_frame.decompress",
              "device_wait_us_per_frame.decompress"]
NEW = COMPRESS + DECOMPRESS
SPAN_READERS = NEW[1:]
MS = 1_000_000


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch's CPU ops on one thread: the chain builder's long torch ops on
    every core in each of several test workers make them wait on one
    another."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame_settings():
    _, conf, _ = run.cell_of(BENCH, CELL)
    return conf["frame"]


def _port_frame(codec, data):
    import divortio_lz4_tpu_torch as pt

    cfg = pt.FrameConfig(**_frame_settings())
    f = pt.compress(data, config=cfg) if codec == "host" else \
        pt.compress_frame(data, cfg, engine="split", device="cpu")
    return np.asarray(f).tobytes()


def test_the_cell_is_kafkas_batch():
    _, conf, mix = run.cell_of(BENCH, CELL)
    assert conf["frame"] == {"block_size": 65536, "block_independence": True,
                             "content_checksum": False,
                             "content_size": False, "block_checksums": False}
    assert conf["reduced"] == [] and conf["engine"] == "split"
    assert set(conf["controls"]) == {"with_content_checksum",
                                     "linked_blocks"}
    reqs = traffic.deck(mix)
    assert mix["deck"] == len(reqs) == 1024 and mix["offsets"] == "drawn"
    assert {r.size for r in reqs} == {BATCH}
    assert mix["corpus_bytes"] == 1 << 28


@pytest.mark.parametrize("codec", ["host", "split"])
def test_port_frames_decode_exactly(codec):
    frame = _frame_settings()
    c = make_corpus(3, 1 << 20)
    # a full batch, a one-byte and an empty one, and one byte over a block
    for n in (BATCH, 1, 0, 65537):
        data = c[7000: 7000 + n]
        out, fr = decode_frame(_port_frame(codec, data))
        assert out.tobytes() == data.tobytes()
        assert fr.faults == [] and checks.stated_faults(fr, frame) == []


@pytest.mark.parametrize("codec", ["host", "split"])
def test_the_header_is_the_one_kafka_reads(codec):
    """FLG 0x60 (version 1, independent blocks, nothing else), BD 0x40
    (64 KB blocks), the header checksum over those two bytes, and the
    EndMark as the frame's last 4 bytes, with no checksum after it."""
    f = _port_frame(codec, make_corpus(4, 1 << 20)[:BATCH])
    assert f[4:7] == bytes([0x60, 0x40, (xxh32(b"\x60\x40", 0) >> 8) & 0xFF])
    fr = read_frame(f)
    off, size, _ = fr.blocks[-1]
    assert off + size == len(f) - 4 and f[-4:] == b"\0\0\0\0"
    assert fr.content_checksum is None and fr.content_size is None


def _few(monkeypatch, n=8, corpus=1 << 24):
    """Cut the cell's deck to its first *n* batches and its corpus to
    *corpus* bytes."""
    real = run.cell_of

    def cell_of(bench, name):
        cell, conf, mix = real(bench, name)
        mix = dict(mix, deck=n, corpus_bytes=corpus,
                   sizes=dict(mix["sizes"], bytes=mix["sizes"]["bytes"][:n]))
        return cell, conf, mix

    monkeypatch.setattr(run, "cell_of", cell_of)


def _run(codec=None, control=None, seed=2**31 + 27):
    res, _, _ = run.run_cell(BENCH, CELL, seed, 0.1, False, device="cpu",
                             codec=codec, control=control)
    return res["correct"], {k: v["value"] for k, v in res["checks"].items()}


def test_a_sound_run_is_correct(monkeypatch):
    _few(monkeypatch)
    ok, numbers = _run()
    assert ok and not any(numbers.values())


@pytest.mark.parametrize("control", ["with_content_checksum",
                                     "linked_blocks"])
def test_each_control_is_not_correct(monkeypatch, control):
    _few(monkeypatch)
    ok, numbers = _run(control=control)
    assert not ok
    assert numbers["frame_faults"] >= 1
    assert numbers["wrong_answers"] == numbers["failed_calls"] == 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "answer", "token"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    _few(monkeypatch)
    ok, numbers = _run(codec=_Broken(_codec(CELL), fault, CELL))
    assert not ok
    assert numbers["wrong_answers"] + numbers["failed_calls"] \
        + numbers["reference_mismatch"] >= 1


def _host(name, s, e):
    return (name, "user_annotation", False, s * MS, e * MS)


def _events():
    """Two compress calls and two decompress calls, with their roots and
    steps. Compress: 96 + 100 ms of roots, of them 12 + 20 and 10 + 10 ms
    in copies. Decompress: 98 + 50 ms, of them 2 + 10 ms in copies."""
    return [_host("lz4bench.compress", 0, 100),
            _host("lz4t.compress_frames", 2, 98),
            _host("lz4t.encode.rows", 4, 10),
            _host("lz4t.encode.chains", 10, 30),
            _host("lz4t.frame.put", 12, 16),
            _host("lz4t.frame.put", 20, 28),
            _host("lz4t.frame.fetch", 30, 50),
            _host("lz4t.encode.serialize", 50, 70),
            _host("lz4t.frame.assemble", 80, 96),
            _host("lz4bench.decompress", 100, 200),
            _host("lz4t.decompress_frames", 101, 199),
            _host("lz4t.frame.index", 101, 105),
            _host("lz4t.decode.parse", 105, 140),
            _host("lz4t.decode.records", 140, 150),
            _host("lz4t.frame.put", 150, 152),
            _host("lz4t.decode.kernel", 152, 160),
            _host("lz4t.frame.fetch", 160, 170),
            _host("lz4t.frame.join", 170, 190),
            _host("lz4bench.compress", 300, 400),
            _host("lz4t.compress_frames", 300, 400),
            _host("lz4t.frame.put", 310, 320),
            _host("lz4t.frame.fetch", 350, 360),
            _host("lz4bench.decompress", 400, 450),
            _host("lz4t.decompress_frames", 400, 450)]


def _fake_run(events):
    rec = types.SimpleNamespace
    return types.SimpleNamespace(
        trace=_trace.from_events(events),
        records=[rec(size=1500, t_decompress=0.1),
                 rec(size=2500, t_decompress=0.1)])


def _counters(monkeypatch, got):
    from divortio_lz4_tpu_torch import tracing

    monkeypatch.setattr(tracing, "counters", lambda: got)


def _read(names, fake):
    return [run.reader(n).read(fake) for n in names]


def test_the_readers_read_their_spans_and_counters(monkeypatch):
    _counters(monkeypatch, {
        "compress_frames": {"frames": 2, "row_pad_bytes": 12000},
        "decompress_frames": {"frames": 2, "decode_blocks": 2}})
    got = dict(zip(NEW, _read(NEW, _fake_run(_events()))))
    assert got == pytest.approx({
        "row_pad_per_byte.compress": 12000 / 4000,
        "host_us_per_frame.compress": (196 - 52) * 1000 / 2,
        "device_wait_us_per_frame.compress": 52 * 1000 / 2,
        "host_us_per_frame.decompress": (148 - 12) * 1000 / 2,
        "device_wait_us_per_frame.decompress": 12 * 1000 / 2})
    # the two parts add up to the roots' wall time a frame
    assert got["host_us_per_frame.compress"] \
        + got["device_wait_us_per_frame.compress"] == 196 * 1000 / 2
    assert got["host_us_per_frame.decompress"] \
        + got["device_wait_us_per_frame.decompress"] == 148 * 1000 / 2


def test_no_span_or_counter_no_reading(monkeypatch):
    # a program without the two counters: the parent of this
    # configuration's cell, whose spans and copies are there
    fake = _fake_run(_events())
    _counters(monkeypatch, {"compress_frames": {"h2d_bytes": 9000},
                            "decompress_frames": {"decode_blocks": 2}})
    assert _read(NEW, fake) == [None] * 5
    # counters at 0: no frame, or no padding
    _counters(monkeypatch, {"compress_frames": {"frames": 0,
                                                "row_pad_bytes": 0},
                            "decompress_frames": {"frames": 0}})
    assert _read(NEW, fake) == [None] * 5
    # no trace, or no port spans in it: the span readers give nothing,
    # the padding is a counter's alone
    _counters(monkeypatch, {"compress_frames": {"frames": 2,
                                                "row_pad_bytes": 4000},
                            "decompress_frames": {"frames": 2}})
    no_trace = types.SimpleNamespace(trace=None, records=fake.records)
    assert _read(SPAN_READERS, no_trace) == [None] * 4
    no_spans = _fake_run([e for e in _events()
                          if not e[0].startswith("lz4t.")])
    assert _read(SPAN_READERS, no_spans) == [None] * 4
    assert _read(NEW[:1], no_trace) == [1.0]


def test_no_counters_module_no_reading(monkeypatch):
    import sys

    import divortio_lz4_tpu_torch

    _counters(monkeypatch, {"compress_frames": {"frames": 2,
                                                "row_pad_bytes": 4000},
                            "decompress_frames": {"frames": 2}})
    fake = _fake_run(_events())
    assert None not in _read(NEW, fake)
    monkeypatch.delattr(divortio_lz4_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "divortio_lz4_tpu_torch.tracing", None)
    assert _read(NEW, fake) == [None] * 5


def _roots_us(trace, kind):
    """The roots' wall time within the *kind* calls, us."""
    roots = [h for h in trace.host if h.name == f"lz4t.{kind}_frames"]
    return _trace.overlap(_trace.union(roots),
                          _trace.calls_of(trace, kind)) / 1e3


def _check_recorded(res, rn, got, n):
    """The five readings of a traced run of *n* round trips of 16 KB."""
    assert res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(m) == set(NEW)
    assert got["compress_frames"]["frames"] == n
    assert got["decompress_frames"]["frames"] == n
    assert m["row_pad_per_byte.compress"] == 3.0
    for kind in ("compress", "decompress"):
        host = m[f"host_us_per_frame.{kind}"]
        wait = m[f"device_wait_us_per_frame.{kind}"]
        assert host > 0.0 and wait > 0.0
        assert host + wait == pytest.approx(_roots_us(rn.trace, kind) / n)
        calls = _trace.calls_of(rn.trace, kind)
        call_us = sum(e - s for s, e in calls) / 1e3 / len(calls)
        assert host + wait == pytest.approx(call_us, rel=0.05)


def test_a_recorded_profile_reports_the_readers(monkeypatch):
    """The cell traced on the CPU on 4 of its batches: one padded 64 KB
    row a frame."""
    from divortio_lz4_tpu_torch import tracing

    _few(monkeypatch, n=4)
    tracing.reset()
    res, _, rn = run.run_cell(BENCH, CELL, 2**31 + 29, 0.1, True,
                              device="cpu")
    got = tracing.counters()
    tracing.reset()
    assert len(rn.records) == 4
    _check_recorded(res, rn, got, 4)


@pytest.mark.cuda
def test_traced_cell_on_the_card(card):
    """The whole cell's deck, traced for one deck on the card."""
    from divortio_lz4_tpu_torch import tracing

    tracing.reset()
    res, _, rn = run.run_cell(BENCH, CELL, 2**31 + 31, 1.0, True)
    got = tracing.counters()
    tracing.reset()
    assert len(rn.records) % 1024 == 0
    _check_recorded(res, rn, got, len(rn.records))
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
